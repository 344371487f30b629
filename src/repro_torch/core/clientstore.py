"""Per-client persistent state (port of ``repro/core/clientstore.py``, the
M == K columns the synchronous round carries).  The population-scale
store (M >> K, cohort sampling) comes with the async engine (ROADMAP
queue 1 item 11)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import tree


class ClientStore(NamedTuple):
    """One row per client (K,)."""
    fitness: torch.Tensor       # last fitness score EWMA
    trust: torch.Tensor         # score-driven EWMA trust
    gate_trust: torch.Tensor    # cosine-gate / guard rejection EWMA
    staleness: torch.Tensor     # i32 rounds since last delivery
    failures: torch.Tensor      # rejected delivery count
    cum_selected: torch.Tensor  # times selected into a team
    ef: Optional[torch.Tensor] = None   # (K, N) fp32 EF residuals, in the
                                        # round's column order (compress on)


def init_store(population: int, *, params=None, fed_cfg=None, device=None,
               fitness_prior: float = 0.5) -> ClientStore:
    """Fresh columns for ``population`` clients.  The EF residual buffer is
    allocated only when ``fed_cfg`` compresses the uplink with error
    feedback; it is one (K, N) fp32 matrix, N the parameter count of
    ``params``, whose per-leaf views are ``tree.row_views(ef, params)``."""
    m = int(population)
    full = lambda v: torch.full((m,), v, dtype=torch.float32, device=device)
    ef = None
    if params is not None and fed_cfg is not None \
            and fed_cfg.compress != "none" and fed_cfg.error_feedback:
        n = sum(p.numel() for p in tree.leaves(params))
        ef = torch.zeros((m, n), dtype=torch.float32, device=device)
    return ClientStore(
        fitness=full(fitness_prior),
        trust=full(0.5),
        gate_trust=full(1.0),
        staleness=torch.zeros((m,), dtype=torch.int32, device=device),
        failures=full(0.0),
        cum_selected=full(0.0),
        ef=ef,
    )
