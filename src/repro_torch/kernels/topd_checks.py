"""Card checks of K7 (``population_select.block_topd`` and the fused
``topd_pallas``), shared by ``tests/test_torch_cuda.py`` and phase 2b of
``chip_smoke.py``.

Each check raises ``AssertionError`` naming the case when the kernel's
candidates are not bitwise ``block_topd_plain``'s (``candidates``), when the
fused launch's (d,) indices are not bitwise the CPU path's
(``block_topd_plain`` then ``_merge``, run on the same card tensors;
``fused``), or when a call launches K7 other than once; past the
shared-memory budget (``LARGE_CASES``) also when the call does not take
K7's global path (``global_path``), and at the largest d that fits when it
does (``smem_path``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import population_select as ps

# (label, M, d, blk, kind); kinds as ``keys`` makes them
CASES = (
    ("gumbel", 1_000_000, 64, 4096, "gumbel"),
    ("gumbel", 16_384, 16, 4096, "gumbel"),          # the async path's shape
    ("gumbel, ragged", 10_007, 64, 4096, "gumbel"),
    ("gumbel, exhausted blocks", 10_007, 64, 64, "gumbel"),
    ("gumbel, 1,563 blocks of 64", 100_000, 16, 64, "gumbel"),
    ("gumbel, 3,125 blocks of 64", 200_000, 16, 64, "gumbel"),
    ("M = 4097", 4_097, 16, 4096, "gumbel"),
    ("d = 1", 100_000, 1, 4096, "gumbel"),
    ("d = 1024", 100_000, 1024, 4096, "gumbel"),
    ("d = blk", 3 * 4096, 4096, 4096, "gumbel"),
    ("d = 290 over 300 blocks", 300 * 4096, 290, 4096, "gumbel"),
    ("duplicates", 3 * 4096, 64, 4096, "dup"),
    ("duplicates, small", 300, 5, 64, "dup"),
    ("+-0.0 minimal", 3, 2, 64, "minimal"),
    ("+-0.0 mixture", 3 * 4096 + 5, 64, 4096, "zeros"),
    ("+-0.0 mixture, small blocks", 1_000, 16, 64, "zeros"),
    ("all equal", 3 * 4096, 64, 4096, "equal"),
    ("all equal, every candidate merged", 1_000_000, 64, 4096, "equal"),
    ("exactly d finite a block", 4 * 4096, 64, 4096, "exact_d"),
    ("mostly -inf, repeated tails", 5_000, 64, 256, "neginf"),
    ("unaligned view", 3 * 4096, 64, 4096, "unaligned"),
    ("unaligned view, ragged", 100_001, 64, 4096, "unaligned"),
)
# (label, M, d, kind) past the shared-memory budget: blk = d, K7's global
# path (``ps_topd_global``)
LARGE_CASES = (
    ("gumbel, d = 16,385", 100_000, 16_385, "gumbel"),
    ("gumbel, d = 20,000", 100_000, 20_000, "gumbel"),
    ("duplicates, d = 20,000", 100_000, 20_000, "dup"),
    ("+-0.0 mixture, d = 17,000", 60_000, 17_000, "zeros"),
    ("mostly -inf, the top-d reaches the tails", 40_000, 16_500, "neginf"),
    ("unaligned view, d = 16,385", 100_001, 16_385, "unaligned"),
)
# kinds on which every route gives argsort's order: no signed zeros, and the
# top-d never reaches an exhausted block's tail
ARGSORT_KINDS = ("gumbel", "unaligned", "dup", "equal", "exact_d")


def keys(m, d, blk, kind, seed, device):
    """(M,) fp32 keys of one case, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    if kind == "minimal":
        g = np.array([-0.0, 0.0, -1.0], np.float32)[:m]
    elif kind in ("gumbel", "unaligned"):
        pri = rng.uniform(0.01, 1.01, m)
        g = (np.log(pri) + rng.gumbel(size=m)).astype(np.float32)
    elif kind == "dup":
        g = rng.integers(0, 30, m).astype(np.float32)
    elif kind == "zeros":           # rare 1.0s: the top-d reaches the zeros
        g = rng.choice(np.array([1.0, -0.0, 0.0, -1.0], np.float32), m,
                       p=[0.002, 0.4, 0.4, 0.198])
    elif kind == "equal":
        g = np.full(m, 0.5, np.float32)
    elif kind == "exact_d":               # d finite keys in every block
        g = np.full(m, -np.inf, np.float32)
        for b in range(0, m, blk):
            n = min(blk, m - b)
            g[b + rng.choice(n, min(d, n), replace=False)] = \
                rng.standard_normal(min(d, n))
    elif kind == "neginf":
        g = rng.standard_normal(m).astype(np.float32)
        g[rng.random(m) < 0.95] = -np.inf
    else:
        raise ValueError(f"unknown kind {kind!r}")
    t = torch.from_numpy(g).to(device)
    if kind == "unaligned":               # a view 4 bytes past an allocation
        buf = torch.empty(m + 1, device=device)
        buf[1:] = t
        t = buf[1:]
    return t


def _once(fn):
    """fn()'s result; raises unless it launched K7 exactly once."""
    start = ps.launch_counts()["block_topd"]
    out = fn()
    if ps.launch_counts()["block_topd"] - start != 1:
        raise AssertionError("K7 did not launch once a call")
    return out


def candidates(g, d, blk):
    """K7's stage 1 on g, padded as ``topd_pallas_plain`` pads it, against
    ``block_topd_plain``; returns the largest absolute error of the finite
    candidate values (0: they are bitwise)."""
    gp, _ = ps._pad_neg_inf(g, blk)
    v, gi = _once(lambda: ps.block_topd(gp, d, blk))
    pv, pgi = ps.block_topd_plain(gp, d, blk)
    if not (torch.equal(v.view(torch.int32), pv.view(torch.int32))
            and torch.equal(gi, pgi)):
        raise AssertionError(f"block_topd M={g.shape[0]} d={d} blk={blk}: "
                             "candidates differ from the plain version's")
    fin = torch.isfinite(pv)
    return float((v[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0


def fused(g, d, blk):
    """The fused launch's (d,) indices on the unpadded g against the CPU
    path's, bitwise; returns them."""
    out = _once(lambda: ps.topd_pallas(g, d, blk=blk))
    if not torch.equal(out, ps.topd_pallas_plain(g, d, blk)):
        raise AssertionError(f"topd_pallas M={g.shape[0]} d={d} blk={blk}: "
                             "the fused launch's indices differ from the "
                             "CPU path's")
    return out


def every_route(g, d, blk):
    """Every route gives argsort's order (``ARGSORT_KINDS``); so does
    ``torch.topk`` where the keys are tie-free."""
    ref = ps.topd_argsort(g, d)
    outs = {m: ps.topd(g, d, method=m, blk=blk) for m in ps.METHODS}
    if torch.unique(g).numel() == g.numel():
        outs["torch.topk"] = torch.topk(g, d).indices.to(torch.int32)
    for name, out in outs.items():
        if not torch.equal(out, ref):
            raise AssertionError(f"topd M={g.shape[0]} d={d}: {name} order "
                                 "differs from argsort")


def global_path(g, d):
    """``topd_pallas`` past the shared-memory budget (blk = d) on the card:
    bitwise the CPU path's indices, through K7's global path, one count a
    call; returns them."""
    start = ps.topd_pallas.global_calls
    out = fused(g, d, d)
    if ps.topd_pallas.global_calls - start != 1:
        raise AssertionError(f"topd_pallas M={g.shape[0]} d={d}: did not "
                             "take the global path")
    return out


def smem_path(g, d):
    """``topd_pallas`` at a d whose CTA fits in shared memory: the one-launch
    path, not the global one."""
    start = ps.topd_pallas.global_calls
    fused(g, d, max(d, ps.BLK))
    if ps.topd_pallas.global_calls != start:
        raise AssertionError(f"topd_pallas d={d} took the global path")
