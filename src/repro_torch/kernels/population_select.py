"""O(M) Gumbel-top-d population selection — the port of
``repro/kernels/population_select.py``.

A without-replacement cohort of d clients with probability proportional to
per-client weights is the top-d of ``log w + Gumbel noise``
(Efraimidis-Spirakis).  The selection is a two-stage segmented reduction:

  stage 1   the keys stream in (blk,)-blocks (blk = max(4096, d)); each
            block reduces to its local top-d candidates (values + global
            indices).  Two engines:
              * ``segmented`` — ``torch.topk`` per (nb, blk) segment, the
                counterpart of the JAX package's XLA ``lax.top_k`` path;
              * ``pallas``   — K7, the hand-written CUDA kernel
                ``block_topd`` (``csrc/population_select.cu``): d rounds of
                max-and-mask per block.  The name is the JAX package's, so
                one config reads the same in both.
  stage 2   a stable descending sort of the nb*d candidates, first d kept.

Every route returns the same indices in the same order as ``argsort``:
descending key, and on equal keys the lower index first (``lax.top_k``'s
and ``jnp.argmax``'s rule).  ``torch.topk`` leaves the order of ties
undefined, so the segmented route takes only the d-th value from it and
picks the tied keys at that value by lowest index itself, and the merge is
``torch.sort(stable=True)``, never ``topk``.

Dispatch: ``block_topd`` launches K7 for a CUDA tensor (or raises) and runs
its plain version ``block_topd_plain`` only for a CPU tensor; it counts its
launches in ``.launches``.  ``draw_gumbel`` takes the noise from a
``torch.Generator``; everything else is a pure function of the keys.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.robust_pipeline import SMEM_LIMIT

METHODS = ("argsort", "segmented", "pallas")
BLK = 4096


def _pad_neg_inf(g, blk):
    m = g.shape[0]
    pad = (-m) % blk
    if pad:
        g = torch.cat([g, torch.full((pad,), -float("inf"), dtype=g.dtype,
                                     device=g.device)])
    return g, m + pad


def topd_argsort(g, d):
    """O(M log M) full-sort baseline."""
    return torch.argsort(-g, stable=True)[:d].to(torch.int32)


def _merge(v, gi, d):
    """Stage 2: the d best of the candidates, in candidate order on ties."""
    j = torch.sort(v.reshape(-1), descending=True, stable=True).indices[:d]
    return gi.reshape(-1)[j]


def topd_segmented(g, d, *, blk=BLK):
    """Blocked two-stage top-d: ``torch.topk`` per segment, then the merge.
    Within a segment the candidates are in ``lax.top_k``'s order: the keys
    above the d-th value, then as many keys equal to it as fill d, lowest
    positions first, sorted by value with ties kept in position order."""
    blk = max(int(blk), d)
    g, mp = _pad_neg_inf(g.float(), blk)
    nb = mp // blk
    seg = g.view(nb, blk)
    kth = torch.topk(seg, d, dim=1).values[:, -1:]
    above = seg > kth
    tied = seg == kth
    need = d - above.sum(1, keepdim=True)
    take = above | (tied & (torch.cumsum(tied, 1) <= need))  # d per row
    # the taken positions in ascending order, without a host sync: taken
    # position p goes to column (rank among the taken), the rest to column d
    rank = torch.cumsum(take, 1) - 1
    col = torch.where(take, rank, torch.full_like(rank, d))
    pos = torch.zeros(nb, d + 1, dtype=torch.int64, device=g.device)
    pos.scatter_(1, col, torch.arange(blk, device=g.device).expand(nb, blk))
    pos = pos[:, :d]
    val = seg.gather(1, pos)
    order = torch.sort(val, dim=1, descending=True, stable=True).indices
    val = val.gather(1, order)
    gi = (pos.gather(1, order)
          + torch.arange(nb, device=g.device)[:, None] * blk).to(torch.int32)
    return _merge(val, gi, d)


# ---------------------------------------------------------------------------
# K7 and its plain version
# ---------------------------------------------------------------------------

def block_topd_plain(g, d, blk):
    """Stage 1 as ``_block_topd_body`` computes it: g (nb*blk,) fp32 ->
    (values (nb, d) fp32, global indices (nb, d) int32), d rounds of
    max-and-mask per block, the first maximum each round."""
    nb = g.shape[0] // blk
    x = g.float().reshape(nb, blk).clone()
    vals = torch.empty(nb, d, device=g.device)
    idx = torch.empty(nb, d, dtype=torch.int64, device=g.device)
    for r in range(d):
        a = torch.argmax(x, dim=1, keepdim=True)
        vals[:, r:r + 1] = x.gather(1, a)
        idx[:, r:r + 1] = a
        x.scatter_(1, a, -float("inf"))
    base = torch.arange(nb, device=g.device)[:, None] * blk
    return vals, (idx + base).to(torch.int32)


def block_topd(g, d, blk):
    """K7.  g: (nb*blk,) fp32 keys padded with -inf -> (values (nb, d) fp32,
    global indices (nb, d) int32): each block's top-d in extraction order.

    Replaces ``repro/kernels/population_select.py:topd_pallas``
    (``_block_topd_body``).  Bound: bytes (each key read once, 8 B written
    per candidate).  Design: one CTA per block holds its keys in shared
    memory and runs d rounds of a strided (max, lowest index) scan, a
    warp-shuffle and one shared-memory reduction, and a masked write.
    """
    if g.dim() != 1 or g.shape[0] % blk:
        raise ValueError(f"keys must be (nb * {blk},), got {tuple(g.shape)}")
    if g.device.type == "cpu":
        return block_topd_plain(g, d, blk)
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"K7 takes float32 keys, got {g.dtype}")
    if not g.is_contiguous():
        raise ValueError("K7 takes contiguous keys")
    if not 1 <= d <= blk:
        raise ValueError(f"need 1 <= d <= blk, got d={d}, blk={blk}")
    if 4 * blk > SMEM_LIMIT - 1024 or g.shape[0] >= 2 ** 31:
        raise ValueError(f"blk={blk}, M={g.shape[0]}: beyond K7's shared "
                         "memory or int32 indices")
    nb = g.shape[0] // blk
    vals = torch.empty(nb, d, device=g.device)
    idx = torch.empty(nb, d, dtype=torch.int32, device=g.device)
    rc = _build.load().ps_block_topd(
        g.data_ptr(), vals.data_ptr(), idx.data_ptr(), nb, blk, d,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ps_block_topd failed: CUDA error {rc}")
    block_topd.launches += 1
    return vals, idx


def reset_launch_counts():
    block_topd.launches = 0


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {"block_topd": block_topd.launches}


reset_launch_counts()


def topd_pallas(g, d, *, blk=BLK):
    """Stage-1 candidates from K7 (its plain version on the CPU), stage-2
    merge by a stable sort."""
    blk = max(int(blk), d)
    g, _ = _pad_neg_inf(g.float(), blk)
    v, gi = block_topd(g, d, blk)
    return _merge(v, gi, d)


def topd(g, d, *, method="segmented", blk=BLK):
    """(d,) int32 indices of the d largest keys of g (M,), descending."""
    d = int(d)
    if d >= g.shape[0]:
        # degenerate cohort >= population: every client, by key order
        return topd_argsort(g, d)
    if method == "argsort":
        return topd_argsort(g, d)
    if method == "segmented":
        return topd_segmented(g, d, blk=blk)
    if method == "pallas":
        return topd_pallas(g, d, blk=blk)
    raise ValueError(f"unknown top-d method {method!r}; known: {METHODS}")


def draw_gumbel(m, generator):
    """(m,) fp32 standard Gumbel noise, -log(-log(u)), u in [tiny, 1)."""
    u = torch.rand(m, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))


def gumbel_topd(logw, d, gumbel, *, method="segmented", blk=BLK):
    """Without-replacement cohort sample proportional to exp(logw): the
    top-d of ``logw + gumbel`` (noise from ``draw_gumbel``).  (d,) int32."""
    return topd(logw.float() + gumbel, d, method=method, blk=blk)
