"""Host-side pygame renderer, decoupled from the compute core.

A copy of ``merging_gym_tpu/ui/render.py`` (the port imports nothing of
the JAX package); pygame is imported when a ``Renderer`` is made.

Faithful re-creation of the reference's dual egocentric views
(merging_env.py:241-352): for each player, the two lane arcs drawn
relative to that player's own position, the own car at a fixed screen
anchor, the other car relative, a grey "ghost" box showing the 3-second
constant-velocity prediction (merging_env.py:287-288), accel/brake/goal
colour coding (red = accelerating or goal 0, blue = braking or goal 1,
merging_env.py:262-284), and a speed + accumulated-reward HUD.

Unlike the reference -- whose env constructor owns a pygame window and
whose step loop is therefore welded to SDL (merging_env.py:82-98) -- this
renderer consumes plain state snapshots (dicts of floats), so the same
training loop runs headless on the card and is visualised only when a
human asks.  Works under ``SDL_VIDEODRIVER=dummy`` for tests.
"""

from __future__ import annotations

import numpy as np

from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core.oracle import _lon2coord

SCALE = 5.0            # merging_env.py:46
WINDOW_H, WINDOW_W = 1000, 300  # merging_env.py:24
ANCHOR_Y = 3 * WINDOW_H / 5     # own-car longitudinal screen anchor
ANCHOR_X = WINDOW_W / 2


def snapshot(state1: dict, state2: dict, r1_acc: float, r2_acc: float) -> dict:
    """Plain-float snapshot consumed by Renderer.render."""
    return {
        "pos1": float(state1["pos"]), "vel1": float(state1["vel"]),
        "acc1": float(state1["acc"]),
        "pos2": float(state2["pos"]), "vel2": float(state2["vel"]),
        "acc2": float(state2["acc"]),
        "r1_acc": float(r1_acc), "r2_acc": float(r2_acc),
    }


def _accel_color(acc, goal):
    """Red = accel / goal 0, blue = brake / goal 1 (merging_env.py:262-284)."""
    if goal is not None:
        if goal == 0:
            return (255, 0, 0)
        if goal == 1:
            return (0, 0, 255)
        return (0, 0, 0)
    if acc > 1e-2:
        return (255, 0, 0)
    if acc < -1e-2:
        return (0, 0, 255)
    return (0, 0, 0)


class Renderer:
    """Owns the pygame window + two per-player surfaces (lazy init)."""

    def __init__(self, wait_ms: int = 50):
        import pygame

        self.pygame = pygame
        self.wait_ms = wait_ms  # ~20 Hz real-time pacing (merging_env.py:342)
        pygame.init()
        self.screen = pygame.display.set_mode((3 * WINDOW_W, WINDOW_H))
        self.screen.fill((0, 0, 0))
        pygame.display.set_caption("On ramp merging experiment")
        self.left = pygame.Surface((WINDOW_W, WINDOW_H))
        self.right = pygame.Surface((WINDOW_W, WINDOW_H))
        self.font = pygame.font.Font(None, 17)
        self.mark_font = pygame.font.SysFont(None, 50)

    # -- drawing helpers ----------------------------------------------------

    def _clear(self):
        self.left.fill((255, 255, 255))
        self.right.fill((255, 255, 255))

    def _car_rect(self, surf, dy, dx, color):
        """Scaled car box at screen offset (dy longitudinal, dx lateral)
        from the anchor."""
        w = SCALE * C.VEHICLE_W
        h = SCALE * C.VEHICLE_H
        cx = dx * SCALE + ANCHOR_X
        cy = dy * SCALE + ANCHOR_Y
        self.pygame.draw.rect(
            surf, color, self.pygame.Rect(cx - w / 2, cy - h / 2, w, h))

    def _ghost(self, surf, dy_t, dx_t):
        """Grey prediction box spanning from the anchor to the 3-s
        constant-velocity position (merging_env.py:287-288)."""
        w = SCALE * C.VEHICLE_W
        pts = [
            (dx_t * SCALE + ANCHOR_X - w / 2, dy_t * SCALE + ANCHOR_Y - SCALE * C.VEHICLE_H / 2),
            (dx_t * SCALE + ANCHOR_X + w / 2, dy_t * SCALE + ANCHOR_Y - SCALE * C.VEHICLE_H / 2),
            (ANCHOR_X + w / 2, ANCHOR_Y + SCALE * C.VEHICLE_H / 2),
            (ANCHOR_X - w / 2, ANCHOR_Y + SCALE * C.VEHICLE_H / 2),
        ]
        self.pygame.draw.polygon(surf, (120, 120, 120), pts)

    def _lanes(self, surf, own_x, own_y):
        """Both lane arcs relative to the viewer (merging_env.py:251-259)."""
        for sgn in (-1.0, 1.0):
            center = (SCALE * (C.W / 2 + sgn * C.R - own_y) + WINDOW_W / 2,
                      -SCALE * own_x + WINDOW_H / 2)
            for dr in (C.VEHICLE_W, -C.VEHICLE_W):
                self.pygame.draw.circle(
                    surf, (0, 0, 0), center, SCALE * (C.R + dr), width=1)

    # -- public API ---------------------------------------------------------

    def render(self, snap: dict, goal=None, goal_op=None, player: int = 1,
               tag_left: str | None = None, tag_right: str | None = None,
               wait: bool = True):
        pg = self.pygame
        x1, y1 = _lon2coord(snap["pos1"], +1.0)
        x2, y2 = _lon2coord(snap["pos2"], -1.0)
        x1t, y1t = _lon2coord(snap["pos1"] + snap["vel1"] * C.PREDICTION_T, +1.0)
        x2t, y2t = _lon2coord(snap["pos2"] + snap["vel2"] * C.PREDICTION_T, -1.0)

        self._clear()
        self._lanes(self.left, x2, y2)
        self._lanes(self.right, x1, y1)

        clr1 = _accel_color(snap["acc1"], goal)
        clr2 = _accel_color(snap["acc2"], goal_op)

        # Left screen = player 2's view: own ghost + own car + opponent.
        self._ghost(self.left, x2t - x2, y2t - y2)
        self._car_rect(self.left, x1 - x2, y1 - y2, (0, 0, 0))
        self._car_rect(self.left, 0.0, 0.0, clr2)
        # Right screen = player 1's view.
        self._ghost(self.right, x1t - x1, y1t - y1)
        self._car_rect(self.right, 0.0, 0.0, clr1)
        self._car_rect(self.right, x2 - x1, y2 - y1, (0, 0, 0))

        # HUD (merging_env.py:321-338).
        self.left.blit(self.font.render(f"Spd: {round(snap['vel2'], 2)}", True, (0, 0, 0)),
                       (0.2 * WINDOW_W, 0.6 * WINDOW_H))
        self.left.blit(self.font.render(f"Rwd:{round(snap['r2_acc'], 2)}", True, (0, 0, 0)),
                       (0.2 * WINDOW_W, 0.6 * WINDOW_H + 15))
        self.right.blit(self.font.render(f"Spd: {round(snap['vel1'], 2)}", True, (0, 0, 0)),
                        (0.7 * WINDOW_W, 0.6 * WINDOW_H))
        self.right.blit(self.font.render(f"Rwd:{round(snap['r1_acc'], 2)}", True, (0, 0, 0)),
                        (0.7 * WINDOW_W, 0.6 * WINDOW_H + 15))
        if tag_left:
            self.left.blit(self.mark_font.render(tag_left, True, (0, 0, 0)),
                           (0.2 * WINDOW_W, 0.1 * WINDOW_H))
        if tag_right:
            self.right.blit(self.mark_font.render(tag_right, True, (0, 0, 0)),
                            (0.2 * WINDOW_W, 0.1 * WINDOW_H))

        self.plot(player)
        if wait:
            pg.time.wait(self.wait_ms)

    def plot(self, player: int = 1):
        """Blit views into the 3-wide window (merging_env.py:346-352)."""
        if player == 1:
            self.screen.blit(self.right, (WINDOW_W, 0))
        elif player == 2:
            self.screen.blit(self.left, (0, 0))
            self.screen.blit(self.right, (2 * WINDOW_W, 0))
        self.pygame.display.update()

    def frame_array(self) -> np.ndarray:
        """Current window as an RGB array (for video export / tests)."""
        return np.transpose(
            self.pygame.surfarray.array3d(self.screen), (1, 0, 2))

    def close(self):
        self.pygame.display.quit()
