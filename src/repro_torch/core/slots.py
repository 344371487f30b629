"""Slotted team scheduling (paper §III, Eqs. (4)-(5)) — port of
``repro/core/slots.py``, branchless on device tensors.

  p(t+1) = p(t)+1 if theta(t) < theta(t-1) else 0          (Eq. 4)
  h(t+1) = p(t+1) >= PFT  or  (t+1) % MSL == 0  or  t == 1 (Eq. 5 + Alg. 1)

plus the adaptive-slot extension: MSL scaled by the team-performance
variance.  The round index ``t`` is the round state's 0-d int32 tensor,
as the JAX scan body's traced ``t``: nothing here branches on it on the
host, so a round captured as a CUDA graph replays for every t.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SlotState(NamedTuple):
    p: torch.Tensor            # consecutive-decline counter, i32
    prev_theta: torch.Tensor   # theta(t-1), f32
    theta_ema: torch.Tensor    # EMA of team theta (adaptive slots), f32
    theta_var: torch.Tensor    # EMA of squared deviation, f32


def init_slot_state(device=None):
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return SlotState(p=torch.tensor(0, dtype=torch.int32, device=device),
                     prev_theta=f(-float("inf")), theta_ema=f(0.0),
                     theta_var=f(0.0))


def update(state: SlotState, theta_t, t, msl, pft, *, adaptive=False,
           ema_decay=0.9):
    """Returns (new_state, h_next: bool tensor) for round t (1-indexed, a
    0-d int tensor).  The decline counter starts once two team evaluations
    exist (t > 2); h is forced True at t=1 so round 2 is still
    free-for-all.  A host int t is taken as a 0-d CPU tensor, which the
    ops treat as a scalar."""
    t = torch.as_tensor(t)
    declined = theta_t < state.prev_theta
    p_next = torch.where((t > 2) & declined, state.p + 1,
                         torch.zeros_like(state.p))

    first = torch.isinf(state.prev_theta)
    ema_prev = torch.where(first, theta_t, state.theta_ema)
    ema = ema_decay * ema_prev + (1 - ema_decay) * theta_t
    var = torch.where(
        first, torch.zeros_like(state.theta_var),
        ema_decay * state.theta_var + (1 - ema_decay)
        * torch.square(theta_t - ema))

    if adaptive:
        rel = torch.sqrt(var) / torch.clamp(torch.abs(ema), min=1e-6)
        msl_eff = torch.clamp(
            torch.round(msl * (2.0 - 3.0 * torch.clamp(rel, max=0.5))),
            max(msl // 2, 1), 2 * msl).int()
    else:
        msl_eff = msl
    h_next = (p_next >= pft) | (torch.remainder(t + 1, msl_eff) == 0) \
        | (t == 1)
    return SlotState(p=p_next, prev_theta=theta_t, theta_ema=ema,
                     theta_var=var), h_next
