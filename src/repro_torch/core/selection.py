"""Client-selection policies (port of ``repro/core/selection.py``):
FedFiTS threshold election, FedAvg, FedRand, FedPow.

Each random policy is split in two: a ``draw_*`` that takes its noise from
a ``torch.Generator``, and a pure function of that noise, so a test can
hand the pure function the JAX package's own draws and expect the exact
mask.  All policies return a float32 mask (K,) — X(k, t) of Eq. (8);
``population_cohort`` returns the async engine's (C,) cohort indices.
Sorts are stable, as ``jnp.argsort`` is.
"""
from __future__ import annotations

import torch

from repro_torch.core import fitness
from repro_torch.kernels import population_select as ps


def _rank_of(order):
    """ranks[order[i]] = i (the inverse permutation), float32."""
    k = order.shape[0]
    return torch.empty(k, device=order.device).scatter_(
        0, order, torch.arange(k, dtype=torch.float32, device=order.device))


def draw_fedfits(k, generator):
    """(floor_u, explore_u): the two uniform draws of the election."""
    dev = generator.device
    return (torch.rand(k, generator=generator, device=dev),
            torch.rand(k, generator=generator, device=dev))


def fedfits_select(scores, beta, avail, floor_u, explore_u, *,
                   floor_prob=0.0, explore_eps=0.0, min_team=1):
    """Threshold-aware election (Eqs. 3, 7-8): clients at or above the
    threshold, plus the participation floor (prob ``floor_prob``) and
    explore-exploit admissions (prob ``explore_eps``); an empty team falls
    back to the ``min_team`` best available clients."""
    thr = fitness.threshold(scores, beta, avail)
    base = (scores >= thr).float() * avail
    floor = (floor_u < floor_prob).float()
    explore = (explore_u < explore_eps).float()
    mask = torch.clamp(base + (floor + explore) * avail, 0.0, 1.0)

    order = torch.argsort(torch.where(avail > 0, -scores,
                                      torch.full_like(scores, float("inf"))),
                          stable=True)
    top = torch.zeros_like(scores).index_fill_(0, order[:min_team], 1.0) \
        * avail
    return torch.where(mask.sum() >= min_team, mask,
                       torch.clamp(mask + top, 0.0, 1.0))


def fedavg_select(avail):
    """FedAvg (c=1.0): everyone available."""
    return avail


def draw_fedrand(k, generator):
    return torch.rand(k, generator=generator, device=generator.device)


def fedrand_select(avail, c, u):
    """FedRand: the m = ceil(c*K_avail) available clients of largest ``u``."""
    m = torch.clamp(torch.ceil(c * avail.sum()), min=1.0)
    pri = torch.where(avail > 0, u, torch.full_like(u, -float("inf")))
    ranks = _rank_of(torch.argsort(-pri, stable=True))
    return ((ranks < m) & (avail > 0)).float()


def draw_fedpow(k, generator):
    """Standard Gumbel noise, -log(-log(u))."""
    return ps.draw_gumbel(k, generator)


def fedpow_select(local_losses, avail, d, m, gumbel, n=None):
    """Power-of-choice [Cho et al. 2020]: a size-d candidate set drawn
    without replacement ∝ n_k (Gumbel-top-d on log n_k + ``gumbel``), then
    the m candidates of highest local loss."""
    if n is None:
        logw = torch.zeros_like(gumbel)
    else:
        logw = torch.log(torch.clamp(n.float(), min=1e-12))
    ninf = torch.full_like(gumbel, -float("inf"))
    cand_pri = torch.where(avail > 0, logw + gumbel, ninf)
    cand = (_rank_of(torch.argsort(-cand_pri, stable=True)) < d) \
        & (avail > 0)
    loss_pri = torch.where(cand, local_losses, ninf)
    sel_rank = _rank_of(torch.argsort(-loss_pri, stable=True))
    return ((sel_rank < m) & cand).float()


def population_cohort(priority, d, gumbel, *, method="segmented", blk=4096):
    """Population-scale cohort sampling: d of M clients without
    replacement, with probability proportional to ``priority`` (M,), by
    Gumbel-top-d over the streaming top-d routes of
    ``kernels/population_select.py`` (``gumbel``: (M,) noise from
    ``population_select.draw_gumbel``).  Returns (d,) int32 population
    indices in descending key order, the same on every route."""
    logw = torch.log(torch.clamp(priority.float(), min=1e-12))
    return ps.gumbel_topd(logw, d, gumbel, method=method, blk=blk)


def participation_ratio(cum_selected):
    """Fraction of clients selected at least once (paper Table VI proxy)."""
    return (cum_selected > 0).float().mean()
