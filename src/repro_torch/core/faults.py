"""System-heterogeneity fault injection — the port of
``repro/core/faults.py``: stragglers, mid-round dropout, partial work.

  stragglers    per-client exponential delay against a deadline.  Delay
                scales are heterogeneous: ``ceil(straggler_frac * K)``
                chronic stragglers (the tail rows by default, the head
                with ``rows="head"``) have mean ``straggler_delay``, the
                rest ``base_delay``.
  dropout       a selected client computes and is billed, but its update
                is lost.
  partial work  client k runs ceil(frac_k * E) of the E local epochs,
                frac_k ~ U[partial_min_frac, 1).

Each sampler is a ``draw_*`` that takes uniforms from a
``torch.Generator`` and a pure function of those uniforms, so a test can
hand the pure function the JAX package's own draws.  The buffered-async
engine wires the stragglers in; the synchronous round's fault path comes
with attacks and scenarios (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class FaultConfig:
    dropout_prob: float = 0.0        # P(selected client's update is lost)
    straggler_frac: float = 0.0      # fraction of chronically slow clients
    straggler_delay: float = 2.0     # mean delay of slow clients
    base_delay: float = 0.0          # mean delay of everyone else (0 = never late)
    deadline: float = 1.0            # round deadline the delay races
    partial_min_frac: float = 1.0    # effective epochs ~ ceil(U[f,1) * E)

    @property
    def stragglers_active(self) -> bool:
        return (self.straggler_frac > 0.0 and self.straggler_delay > 0.0) \
            or self.base_delay > 0.0

    @property
    def dropout_active(self) -> bool:
        return self.dropout_prob > 0.0

    @property
    def partial_active(self) -> bool:
        return self.partial_min_frac < 1.0

    @property
    def active(self) -> bool:
        return self.stragglers_active or self.dropout_active \
            or self.partial_active


def delay_scales(fl: FaultConfig, n_clients: int, *, rows: str = "tail",
                 device=None):
    """(K,) fp32 per-client mean delays: ``straggler_delay`` for the
    chronic stragglers (the ``"tail"`` or ``"head"`` rows), ``base_delay``
    for everyone else."""
    k = n_clients
    if fl.straggler_frac > 0:
        n_slow = min(max(math.ceil(fl.straggler_frac * k - 1e-9), 1), k)
    else:
        n_slow = 0
    ar = torch.arange(k, device=device)
    if rows == "head":
        is_slow = (ar < n_slow).float()
    elif rows == "tail":
        is_slow = (ar >= k - n_slow).float()
    else:
        raise ValueError(f"rows must be 'head' or 'tail', got {rows!r}")
    return fl.base_delay + (fl.straggler_delay - fl.base_delay) * is_slow


def draw_delays(n, generator):
    """(n,) uniforms in [1e-7, 1) for ``sample_delays``."""
    u = torch.rand(n, generator=generator, device=generator.device)
    return u * (1.0 - 1e-7) + 1e-7


def sample_delays(scale, u):
    """Exponential arrival delays with per-client mean ``scale`` from
    uniforms ``u`` in [1e-7, 1).  A zero scale is an always-instant
    client."""
    return scale * (-torch.log(u))


def draw_arrivals(n, generator):
    return draw_delays(n, generator)


def sample_arrivals(fl: FaultConfig, u):
    """(K,) 0/1 arrival mask: client k arrives iff its delay beats the
    deadline (``u`` from ``draw_arrivals``)."""
    delay = sample_delays(delay_scales(fl, u.shape[0], device=u.device), u)
    return (delay <= fl.deadline).float()


def draw_dropout(n, generator):
    return torch.rand(n, generator=generator, device=generator.device)


def sample_dropout(fl: FaultConfig, u, team):
    """(K,) 0/1 mask of selected clients whose update is lost (``u`` in
    [0, 1) from ``draw_dropout``)."""
    return (u < fl.dropout_prob).float() * team


def draw_epochs(fl: FaultConfig, n, generator):
    """(n,) fractions in [partial_min_frac, 1) for ``sample_epochs``."""
    u = torch.rand(n, generator=generator, device=generator.device)
    return u * (1.0 - fl.partial_min_frac) + fl.partial_min_frac


def sample_epochs(frac, local_epochs: int):
    """(K,) int32 effective local-epoch counts in [1, E] from fractions
    ``frac`` (``draw_epochs``)."""
    eff = torch.ceil(frac * local_epochs).to(torch.int32)
    return torch.clamp(eff, 1, local_epochs)
