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
                (``csrc/population_select.cu``): each block's keys above a
                bound (or a radix select), ranked in shared memory.  The
                name is the JAX package's, so one config reads the same in
                both.
  stage 2   the d best of the nb*d candidates.  On the card K7 does it in
            the same launch (the last block to finish merges); on the CPU a
            stable sort.

Each route orders keys as the JAX package's route of the same name does:

  * ``segmented`` and ``pallas``'s merge rank by ``lax.top_k``'s total order
    of floats, +0.0 above -0.0, and on equal bits the lower position first.
    ``_order_key`` maps the bits to an int32 that orders that way, and the
    ranking runs on it: the kth value from ``torch.topk`` (whose order of
    ties is undefined), the tied keys at it picked by lowest index here, and
    the merge a stable ``torch.sort``.
  * ``pallas``'s stage 1 (``block_topd_plain``) keeps ``jnp.argmax``'s rule:
    -0.0 equals +0.0, the first index wins.
  * ``argsort`` and the d >= M route keep ``jnp.argsort``'s: -0.0 equals
    +0.0, the lower index first.

Gumbel keys are tie-free almost surely, so the routes agree on real draws;
on keys tied at +-0.0 they differ as the JAX package's routes do.

Dispatch: ``block_topd`` (stage 1) and ``topd_pallas`` (both stages) launch
K7 for a CUDA tensor (or raise) and run the plain versions
(``block_topd_plain``, ``topd_pallas_plain``) only for a CPU tensor; every
call that launches counts one in ``block_topd.launches``.  Where
``topd_pallas``'s CTA would pass the shared-memory limit (blk = d >
16,384), its merged indices come from K7's global path
(``ps_topd_global``: a radix select and a bitonic sort over global memory,
bitwise the same indices; each such call also counts one in
``topd_pallas.global_calls``).  ``draw_gumbel`` takes the
noise from a ``torch.Generator``; everything else is a pure function of the
keys.
"""
from __future__ import annotations

import torch

from repro_torch import device
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


def _order_key(x):
    """int32 image of fp32 bits in ``lax.top_k``'s order: a larger float has
    a larger key, and +0.0 (0) sits above -0.0 (-1)."""
    i = x.contiguous().view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def topd_argsort(g, d):
    """O(M log M) full-sort baseline."""
    return torch.argsort(-g, stable=True)[:d].to(torch.int32)


def _merge(key, gi, d):
    """Stage 2: the d best candidates by their ``_order_key``s, in candidate
    order on equal keys."""
    j = torch.sort(key.reshape(-1), descending=True, stable=True).indices[:d]
    return gi.reshape(-1)[j]


def topd_segmented(g, d, *, blk=BLK):
    """Blocked two-stage top-d: ``torch.topk`` per segment, then the merge,
    on the keys' ``_order_key``s.  Within a segment the candidates are in
    ``lax.top_k``'s order: the keys above the d-th, then as many keys equal
    to it as fill d, lowest positions first, sorted by key with ties kept
    in position order."""
    blk = max(int(blk), d)
    g, mp = _pad_neg_inf(g.float(), blk)
    nb = mp // blk
    seg = _order_key(g).view(nb, blk)
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
    key = seg.gather(1, pos)
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    key = key.gather(1, order)
    gi = (pos.gather(1, order)
          + torch.arange(nb, device=g.device)[:, None] * blk).to(torch.int32)
    return _merge(key, gi, d)


# ---------------------------------------------------------------------------
# K7 and its plain versions
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


def topd_pallas_plain(g, d, blk=BLK):
    """Both stages of ``topd_pallas`` in plain torch: the keys padded with
    -inf, ``block_topd_plain``, then the stable merge."""
    blk = max(int(blk), d)
    gp, _ = _pad_neg_inf(g.float(), blk)
    v, gi = block_topd_plain(gp, d, blk)
    return _merge(_order_key(v), gi, d)


THREADS = 256           # K7: threads a CTA (csrc/population_select.cu)
SURVIVORS = 2048        # K7: the shared survivors of a bound
SHARED_STATIC = 3120    # K7: sizeof(Shared), its static shared memory


def smem_bytes(blk, d):
    """K7's shared memory a CTA at (blk, d), dynamic and static: the
    block's keys as float4s (padded to THREADS of them), the survivors and
    a power of two >= d of 8-byte slots, and the static ``Shared`` struct.
    ``lib.ps_topd_smem`` computes the same in the CUDA source."""
    nq = -(-(-(-blk // 4)) // THREADS) * THREADS
    n2 = 1
    while n2 < d:
        n2 <<= 1
    return 16 * nq + 8 * (SURVIVORS + n2) + SHARED_STATIC


_COUNTERS = {}          # (device, stream) -> the merge's completion counter


def _launch(g, d, blk, merge):
    """K7 on g (M,) fp32 CUDA keys: (values (nb, d), indices (nb, d), and
    the merged (d,) indices or None), nb = ceil(M / blk)."""
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"K7 takes float32 keys, got {g.dtype}")
    if g.dim() != 1 or not g.is_contiguous():
        raise ValueError("K7 takes one contiguous vector of keys")
    m = g.shape[0]
    if not 1 <= d <= blk:
        raise ValueError(f"need 1 <= d <= blk, got d={d}, blk={blk}")
    lib = _build.load()
    if m + blk >= 2 ** 31:
        raise ValueError(f"blk={blk}, M={m}: beyond K7's int32 indices")
    stream = torch.cuda.current_stream(g.device).cuda_stream
    if lib.ps_topd_smem(blk, d) > SMEM_LIMIT:
        if not (merge and blk == d):
            raise ValueError(f"blk={blk}, d={d}: beyond K7's shared memory "
                             "(the global path merges blocks of d keys)")
        # every block's candidates are all its keys: the merged top-d by a
        # select and a sort over global memory, in the wrapper's scratch
        scratch = torch.empty(lib.ps_topd_global_bytes(m, blk, d),
                              dtype=torch.uint8, device=g.device)
        out = torch.empty(d, dtype=torch.int32, device=g.device)
        rc = lib.ps_topd_global(g.data_ptr(), m, blk, d, scratch.data_ptr(),
                                out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"ps_topd_global failed: CUDA error {rc}")
        block_topd.launches += 1
        topd_pallas.global_calls += 1
        return None, None, out
    nb = -(-m // blk)
    vals = torch.empty(nb, d, device=g.device)
    idx = torch.empty(nb, d, dtype=torch.int32, device=g.device)
    out = counter = None
    if merge:
        out = torch.empty(d, dtype=torch.int32, device=g.device)
        key = (g.device.index, stream)
        if key not in _COUNTERS:        # zeroed once; each launch leaves 0
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "K7's merge counter first needed during CUDA graph "
                    "capture; run one eager step on the capture stream")
            _COUNTERS[key] = torch.zeros(1, dtype=torch.int32,
                                         device=g.device)
        counter = _COUNTERS[key]
    ptr = lambda t: 0 if t is None else t.data_ptr()
    rc = lib.ps_topd(g.data_ptr(), m, blk, d, vals.data_ptr(), idx.data_ptr(),
                     ptr(out), ptr(counter), stream)
    if rc != 0:
        raise RuntimeError(f"ps_topd failed: CUDA error {rc}")
    block_topd.launches += 1
    return vals, idx, out


def block_topd(g, d, blk):
    """K7's stage 1.  g: (nb*blk,) fp32 keys padded with -inf -> (values
    (nb, d) fp32, global indices (nb, d) int32): each block's top-d in
    extraction order.

    Replaces ``repro/kernels/population_select.py:topd_pallas``
    (``_block_topd_body``).  Bound: bytes (each key read once, 8 B written
    per candidate).  Design (``csrc/population_select.cu``): one CTA per
    block reads the keys once into shared memory; for d <= 256 a bound from
    the warps' sorted thread maxima keeps ~2d keys, ranked by counting,
    else a radix select (one barrier a pass, at most six); no step repeats
    d times.
    """
    if g.dim() != 1 or g.shape[0] % blk:
        raise ValueError(f"keys must be (nb * {blk},), got {tuple(g.shape)}")
    if device.plain_route(g):
        return block_topd_plain(g, d, blk)
    return _launch(g, d, blk, merge=False)[:2]


def reset_launch_counts():
    block_topd.launches = 0
    topd_pallas.global_calls = 0


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {"block_topd": block_topd.launches}


def topd_pallas(g, d, *, blk=BLK):
    """Both stages through K7: on the card one launch on the unpadded keys,
    which merges the candidates in its last block (no padding copy, no
    sort), or, past the shared-memory limit, K7's global path; on the CPU
    ``topd_pallas_plain``."""
    blk = max(int(blk), d)
    g = g.float()
    if device.plain_route(g):
        return topd_pallas_plain(g, d, blk)
    return _launch(g, d, blk, merge=True)[2]


reset_launch_counts()


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
