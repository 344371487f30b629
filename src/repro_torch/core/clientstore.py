"""Per-client persistent state — the port of ``repro/core/clientstore.py``.

One (M,) column per registered client: fitness, trust, gate_trust,
staleness, failures, cum_selected, plus the (M, N) EF residuals when the
uplink is compressed with error feedback.  The synchronous round carries
M == K.  The buffered-async engine (``core/async_engine.py``) runs M >> C:
it samples a (C,) cohort by O(M) Gumbel-top-d over ``selection_priority``,
``gather``s those rows, and writes the round's outcomes back with O(C)
scatters (``record_*``).

The scatters return new columns; the store is never updated in place.
Duplicate owners (a client's fresh and buffered deliveries in one round)
resolve as the JAX package's scatters do on XLA's CPU backend: adds and
products compound (``index_add``, ``index_reduce(..., "prod")``), and a set
keeps the last row's value, decided here explicitly because
``index_put_`` with duplicate indices is nondeterministic on CUDA.
Targets that JAX drops (``mode="drop"``, index M) go to one extra slot
that is cut off afterwards.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import tree
from repro_torch.core import selection

_EPS = 1e-12


class ClientStore(NamedTuple):
    """One row per registered client (M,)."""
    fitness: torch.Tensor       # last fitness score EWMA (selection prior)
    trust: torch.Tensor         # score-driven EWMA trust
    gate_trust: torch.Tensor    # cosine-gate / guard rejection EWMA
    staleness: torch.Tensor     # i32 rounds since last delivery
    failures: torch.Tensor      # abandoned / rejected delivery count
    cum_selected: torch.Tensor  # times selected into a team or cohort
    ef: Optional[torch.Tensor] = None   # (M, N) fp32 EF residuals, in the
                                        # round's column order (compress on)

    @property
    def population(self) -> int:
        return self.fitness.shape[0]


def init_store(population: int, *, params=None, fed_cfg=None, device=None,
               fitness_prior: float = 0.5) -> ClientStore:
    """Fresh columns for ``population`` clients.  The EF residual buffer is
    allocated only when ``fed_cfg`` compresses the uplink with error
    feedback; it is one (M, N) fp32 matrix, N the parameter count of
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


def gather(store: ClientStore, idx) -> ClientStore:
    """The cohort's rows (C,) of every column."""
    i = idx.long()
    return ClientStore(*(None if c is None else c.index_select(0, i)
                         for c in store))


def selection_priority(store: ClientStore) -> torch.Tensor:
    """(M,) sampling weight of the cohort draw: fitness prior times both
    trust tracks, floored so that every registered client stays
    reachable."""
    pri = (store.fitness + 0.05) * store.trust * store.gate_trust
    return torch.clamp(pri, min=_EPS)


def select_cohort(store: ClientStore, d: int, gumbel, *, method="segmented",
                  blk: int = 4096) -> torch.Tensor:
    """A without-replacement cohort of ``d`` clients, probability
    proportional to ``selection_priority``, by Gumbel-top-d over the (M,)
    noise ``gumbel``: (d,) int32 indices."""
    return selection.population_cohort(selection_priority(store), d, gumbel,
                                       method=method, blk=blk)


# ----------------------------------------------------------------------
# round-outcome scatters, O(C) against the (M,) columns
# ----------------------------------------------------------------------

def _targets(owners, mask, m):
    """Owner rows where ``mask`` > 0, the drop slot ``m`` elsewhere."""
    return torch.where(mask > 0, owners.long(),
                       torch.full_like(owners, m, dtype=torch.long))


def _with_slot(col, fill):
    """``col`` (M,) with one extra drop slot at index M."""
    return torch.cat([col, col.new_full((1,), fill)])


def record_selection(store: ClientStore, idx) -> ClientStore:
    """cum_selected + 1 for the sampled cohort."""
    i = idx.long()
    return store._replace(cum_selected=store.cum_selected.index_add(
        0, i, torch.ones(i.shape[0], device=i.device)))


def record_fitness(store: ClientStore, idx, scores, decay: float
                   ) -> ClientStore:
    """EWMA the cohort's fitness scores (computed when the work ran) into
    the store.  ``idx`` holds distinct clients."""
    i = idx.long()
    new = decay * store.fitness[i] + (1.0 - decay) * scores
    return store._replace(fitness=store.fitness.index_copy(0, i, new))


def record_deliveries(store: ClientStore, owners, delivered_mask
                      ) -> ClientStore:
    """Staleness: + 1 for everyone, 0 for the clients whose update entered
    this round's aggregation (on time or from the buffer)."""
    m = store.population
    hit = torch.zeros(m + 1, dtype=torch.bool, device=owners.device)
    hit.index_fill_(0, _targets(owners, delivered_mask, m), True)
    stale = store.staleness + 1
    return store._replace(
        staleness=torch.where(hit[:m], torch.zeros_like(stale), stale))


def record_failures(store: ClientStore, owners, failed_mask, *,
                    trust_penalty: float = 0.7) -> ClientStore:
    """Each failed delivery (retries exhausted, buffer overflow, guard
    rejection) adds one failure and multiplies trust by ``trust_penalty``;
    duplicate owners compound."""
    m = store.population
    tgt = _targets(owners, failed_mask, m)
    ones = torch.ones(tgt.shape[0], device=tgt.device)
    fails = _with_slot(store.failures, 0.0).index_add(0, tgt, ones)[:m]
    pen = torch.ones(m + 1, device=tgt.device).index_reduce(
        0, tgt, torch.full_like(ones, trust_penalty), "prod")[:m]
    return store._replace(failures=fails, trust=store.trust * pen)


def record_gate_trust(store: ClientStore, owners, part_mask, gated_mask,
                      decay: float) -> ClientStore:
    """Cosine-gate EWMA: participating owners decay toward (1 - gated),
    everyone else holds.  A client with several participating rows keeps
    the value of its last row, as the JAX package's scatter does."""
    m = store.population
    tgt = _targets(owners, part_mask, m)
    old = store.gate_trust[torch.clamp(owners.long(), 0, m - 1)]
    new = decay * old + (1.0 - decay) * (1.0 - gated_mask)
    r = torch.arange(tgt.shape[0], device=tgt.device)
    later = (tgt[None, :] == tgt[:, None]) & (r[None, :] > r[:, None])
    last = ~later.any(1)                  # no later row writes this target
    tgt = torch.where(last, tgt, torch.full_like(tgt, m))
    gt = _with_slot(store.gate_trust, 0.0).index_put(
        (tgt,), torch.where(part_mask > 0, new, torch.zeros_like(new)))
    return store._replace(gate_trust=gt[:m])
