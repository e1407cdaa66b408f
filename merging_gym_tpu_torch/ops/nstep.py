"""N-step return windows for vectorised envs.

Counterpart of ``merging_gym_tpu/ops/nstep.py``.  Per env, a sliding FIFO
of the last ``n`` transitions with incrementally accumulated discounted
returns: slot ``k`` holds the entry of age ``k + 1``; each step adds
``gamma**age * r`` to every open entry, shifts the window and inserts the
new entry; an entry matures at age ``n`` and is emitted with ``done=False``
and this step's post-step obs as its bootstrap; when the episode ends all
open entries flush with their truncated returns and ``done=True``.
Used by ``agents.rainbow`` for ``n_step > 1``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class NStepState:
    obs: torch.Tensor     # f32[n, envs, obs_dim]
    action: torch.Tensor  # i32[n, envs]
    ret: torch.Tensor     # f32[n, envs] accumulated discounted return
    length: torch.Tensor  # i32[envs] open entries (after this step's insert)


def nstep_init(n: int, num_envs: int, obs_dim: int,
               device=None) -> NStepState:
    return NStepState(
        obs=torch.zeros(n, num_envs, obs_dim, dtype=torch.float32,
                        device=device),
        action=torch.zeros(n, num_envs, dtype=torch.int32, device=device),
        ret=torch.zeros(n, num_envs, dtype=torch.float32, device=device),
        length=torch.zeros(num_envs, dtype=torch.int32, device=device))


def nstep_update(state: NStepState, obs, action, reward, done, next_obs,
                 gamma: float):
    """Fold one env step into the windows.

    ``obs`` f[envs, d] (pre-step), ``action`` i32[envs], ``reward``
    f[envs], ``done`` bool[envs], ``next_obs`` f[envs, d] (post-step,
    pre-reset).  Returns ``(new_state, items, mask)``: ``items`` a flat
    ``[n * envs]`` transition dict, ``mask`` the emitted ones.
    """
    n, envs = state.obs.shape[0], obs.shape[0]
    dev = state.obs.device
    reward = reward.to(torch.float32)
    k = torch.arange(n, device=dev)

    # 1. gamma**age * r into the open entries (slot k has age k + 1).
    ages = torch.arange(1, n + 1, dtype=torch.float32, device=dev)[:, None]
    open_mask = k[:, None] < state.length[None, :]
    ret = state.ret + torch.where(open_mask, (gamma ** ages) * reward[None, :],
                                  0.0)

    # 2. Shift by one age and insert the new entry at slot 0.
    def shift(buf, new):
        return torch.cat([new[None].to(buf.dtype), buf[:-1]])

    new_obs = shift(state.obs, obs.to(torch.float32))
    new_action = shift(state.action, action)
    new_ret = shift(ret, reward)
    length = torch.clamp(state.length + 1, max=n)

    # 3. Emission: the mature slot in steady state, every valid slot on
    # episode end.
    valid = k[:, None] < length[None, :]
    mature = (k == n - 1)[:, None] & valid
    emit = torch.where(done[None, :], valid, mature)
    items = {
        "obs": new_obs.reshape(n * envs, -1),
        "action": new_action.reshape(n * envs),
        "reward": new_ret.reshape(n * envs),
        "next_obs": next_obs.to(torch.float32)[None].expand(
            n, *next_obs.shape).reshape(n * envs, -1),
        "done": done[None].expand(n, envs).reshape(n * envs),
    }

    # 4. The mature slot frees up; done clears the window.
    length = torch.where(done, 0, torch.where(length >= n, n - 1, length))
    return (NStepState(obs=new_obs, action=new_action, ret=new_ret,
                       length=length.to(torch.int32)), items,
            emit.reshape(n * envs))
