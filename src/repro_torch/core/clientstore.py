"""Per-client persistent state (port of ``repro/core/clientstore.py``, the
M == K columns the synchronous round carries).  The population-scale
store (M >> K, cohort sampling, EF residual handles) comes with the async
engine (ROADMAP queue 1 item 11)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class ClientStore(NamedTuple):
    """One row per client (K,)."""
    fitness: torch.Tensor       # last fitness score EWMA
    trust: torch.Tensor         # score-driven EWMA trust
    gate_trust: torch.Tensor    # cosine-gate / guard rejection EWMA
    staleness: torch.Tensor     # i32 rounds since last delivery
    failures: torch.Tensor      # rejected delivery count
    cum_selected: torch.Tensor  # times selected into a team


def init_store(population: int, *, device=None,
               fitness_prior: float = 0.5) -> ClientStore:
    m = int(population)
    full = lambda v: torch.full((m,), v, dtype=torch.float32, device=device)
    return ClientStore(
        fitness=full(fitness_prior),
        trust=full(0.5),
        gate_trust=full(1.0),
        staleness=torch.zeros((m,), dtype=torch.int32, device=device),
        failures=full(0.0),
        cum_selected=full(0.0),
    )
