"""Psychology-experiment protocol screens.

A copy of ``merging_gym_tpu/ui/screens.py`` (the port imports nothing of
the JAX package).

Ports the reference's experiment flow (merging_env.py:355-395): intro
instructions (3 s), fixation-cross preparation with a random 1-3 s wait,
per-episode feedback points (3 s), and the final total screen (10 s).
Timing is parameterised so automated tests can run them instantly.
"""

from __future__ import annotations

import numpy as np

from merging_gym_tpu_torch.ui.render import WINDOW_H, WINDOW_W, Renderer


class ExperimentScreens:
    def __init__(self, renderer: Renderer, time_scale: float = 1.0):
        self.r = renderer
        self.time_scale = time_scale

    def _wait(self, ms: int):
        self.r.pygame.time.wait(int(ms * self.time_scale))

    def _blank(self):
        self.r.left.fill((255, 255, 255))
        self.r.right.fill((255, 255, 255))

    def _text_both(self, text: str, x_frac: float = 0.1):
        msg = self.r.font.render(text, True, (0, 0, 0))
        pos = (x_frac * WINDOW_W, 3 * WINDOW_H / 5)
        self.r.left.blit(msg, pos)
        self.r.right.blit(msg, pos)

    def intro(self, player: int = 1):
        """merging_env.py:355-366."""
        self._blank()
        self.r.plot(player)
        self._wait(1000)
        self._text_both("Please pass the ramp quickly without collision")
        self.r.plot(player)
        self._wait(3000)

    def prepare(self, player: int = 1, rng=None):
        """Fixation cross + U(1, 3) s wait (merging_env.py:368-377)."""
        self._blank()
        cx, cy = 0.5 * WINDOW_W, 3 * WINDOW_H / 5
        for surf in (self.r.left, self.r.right):
            self.r.pygame.draw.line(surf, (0, 0, 0), (cx - 10, cy), (cx + 10, cy), 3)
            self.r.pygame.draw.line(surf, (0, 0, 0), (cx, cy - 10), (cx, cy + 10), 3)
        self.r.plot(player)
        rng = rng or np.random.default_rng()
        self._wait(int(rng.uniform(1000, 3000)))

    def feedback(self, r1_acc: float, r2_acc: float, player: int = 1):
        """Per-episode points (merging_env.py:380-387)."""
        self._blank()
        msg_l = self.r.font.render(f"You earn {round(r2_acc, 2)} points", True, (0, 0, 0))
        msg_r = self.r.font.render(f"You earn {round(r1_acc, 2)} points", True, (0, 0, 0))
        self.r.left.blit(msg_l, (0.3 * WINDOW_W, 3 * WINDOW_H / 5))
        self.r.right.blit(msg_r, (0.3 * WINDOW_W, 3 * WINDOW_H / 5))
        self.r.plot(player)
        self._wait(3000)

    def finish(self, sum_r1: float, sum_r2: float, player: int = 1):
        """Session total (merging_env.py:389-395)."""
        self._blank()
        msg_l = self.r.font.render(
            f"Games completed. Reward: {round(sum_r2, 2)}", True, (0, 0, 0))
        msg_r = self.r.font.render(
            f"Games completed. Reward: {round(sum_r1, 2)}", True, (0, 0, 0))
        self.r.left.blit(msg_l, (0.2 * WINDOW_W, 3 * WINDOW_H / 5))
        self.r.right.blit(msg_r, (0.2 * WINDOW_W, 3 * WINDOW_H / 5))
        self.r.plot(player)
        self._wait(10000)
