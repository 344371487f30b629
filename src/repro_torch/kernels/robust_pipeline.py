"""Fused robust-aggregation pipeline (paper Eq. 11) — the port of
``repro/kernels/robust_pipeline.py`` onto hand-written CUDA kernels
(``csrc/robust_pipeline.cu``).

  pass 1   K1 ``cosine_gate_partials``: per cohort, the coordinate-median
           reference by the stable-rank network and the per-client cosine
           partials dot(x_i, med), ||x_i||^2, ||med||^2, in one read.
  gate     ``_resolve_gate``: O(G*C) scalars in torch, on the device.
  pass 2   K2 ``gated_combine``: weighted mean, trimmed mean or median
           under the gated mask, one more read.
  krum     K3 ``pairwise_gram``: the Gram matrix in one more read; the
           distances and the O(G*C^2) Krum scoring stay in torch, as they
           stay in jnp in the JAX package.

Layout: the kernels take one (G, C, N) fp32 matrix, or a tree's leaves side
by side, each its own (G, C, n_l) fp32 matrix, through a segment table
(``SegRows`` in ``csrc/robust_pipeline.cuh``; at most ``MAX_SEGS`` leaves).
The round writes each client's update straight into per-leaf views of one
preallocated (C, N) buffer, which streams as one matrix; a tree of several
leaves streams in place through the table, with no concatenate, as the TPU
segment table avoids XLA's.  The kernels, their plan and their sums are the
same either way, so a tree's aggregate is bitwise that of its concatenation.

Flat wrappers (K4a-c): the JAX package keeps a second, pre-flattened form of
the three kernels (``cosine_gate_partials``, ``gated_combine``,
``pairwise_sq_dists_blocked``) behind ``fused_pipeline`` and the ``*_flat``
tree wrappers.  Here the kernels already take one flat matrix, so K4a-c are
not a second path: they are the same entry points (``rp_pass1``,
``rp_combine``, ``rp_gram``) reached through the same pipeline with
``flat=True``, which counts the launches on the K4 names
(``flat_launch_counts``) so that they can be told apart.

Dispatch: each wrapper launches its kernel for a CUDA tensor (and raises if
it cannot) and runs its plain PyTorch version, defined beside it, only for
a CPU tensor.  Each wrapper counts its launches in ``.launches``; the plain
versions are not counted.
"""
from __future__ import annotations

import torch

from repro_torch import device, tree
from repro_torch.kernels import _build
from repro_torch.kernels.robust_agg import _BIG, stable_ranks

PASS1_THREADS = 256     # K1/K4a/K6a: threads a pass-1 block (C <= 64)
PASS1_TILE_COLS = 128   # K1/K4a/K6a past 64 rows: columns a block
COMBINE_THREADS = 128   # K2/K4b/K5/K6b: threads per block
GRAM_BLOCKS_PER_SM = 4  # K3/K6c: blocks to aim for, 4 a SM of the card
PLAIN_CHUNK = 8192      # plain versions: columns per step (bounds the
                        # (C, C, chunk) compare tensor)
SMEM_LIMIT = 232448     # bytes of shared memory a Hopper block may use
MAX_SEGS = 64           # leaves of one launch (kMaxSegs in the .cuh)
MODES = {"mean": 0, "trimmed": 1, "median": 2}


def _cdiv(a, b):
    return -(-a // b)


def _segs(x):
    """The leaves of ``x``: one (G, C, N) matrix, or a list of (G, C, n_l)
    leaves side by side."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _offsets(segs):
    """Each leaf's first column in the concatenation, and N last."""
    off = [0]
    for t in segs:
        off.append(off[-1] + t.shape[-1])
    return off


def dims(x):
    """(G, C, N) of ``x`` (``_segs``): N sums the leaves' widths."""
    segs = _segs(x)
    return (*segs[0].shape[:-1], _offsets(segs)[-1])


def _check_cuda(x, *small):
    segs = _segs(x)
    for s in segs:
        if s.dtype != torch.float32:
            raise TypeError(f"CUDA kernels take float32 updates, got "
                            f"{s.dtype}")
        if not s.is_contiguous():
            raise ValueError("CUDA kernels take contiguous (G, C, n) "
                             "matrices")
        if s.dim() != 3 or s.shape[:2] != segs[0].shape[:2]:
            raise ValueError(f"CUDA kernels take (G, C, n) leaves, got "
                             f"{[tuple(t.shape) for t in segs]}")
    if dims(x)[-1] >= 2 ** 31:
        raise ValueError(f"CUDA kernels take N < 2^31, got {dims(x)}")
    if len(segs) > MAX_SEGS:
        raise ValueError(f"{len(segs)} leaves: one launch takes at most "
                         f"{MAX_SEGS}")
    return [t.to(device=segs[0].device, dtype=torch.float32).contiguous()
            for t in small]


class _Table:
    """The segment table of leaves ``segs`` for a *_seg entry point: host
    arrays of their pointers and first columns, alive while it is."""

    def __init__(self, segs):
        import ctypes
        off = _offsets(segs)
        self.ptrs = (ctypes.c_void_p * len(segs))(*[t.data_ptr()
                                                    for t in segs])
        self.off = (ctypes.c_int * len(off))(*off)
        self.args = (ctypes.addressof(self.ptrs), ctypes.addressof(self.off),
                     len(segs))


def _launch(fn, *args):
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")


def gram_tile(c):
    """(side, stage depth) of the Gram kernel's output tiles at C rows, as
    ``launch_gram`` in ``csrc/robust_pipeline.cuh`` picks them: 16 x 16
    tiles of 2 x 2 micro-tiles for C <= 16, else 32 x 32 of 4 x 4."""
    side = 16 if c <= 16 else 32
    return side, 1024 // side


def gram_split(g, c, n, sms):
    """(nsplit, chunk) of K3 / K6c on a (G, C, N) matrix on a card of
    ``sms`` SMs: nsplit column chunks of ``chunk`` columns (a multiple of
    the stage depth) cover N exactly, so that the upper triangle's tiles
    times nsplit times G come to at least GRAM_BLOCKS_PER_SM * sms blocks
    where N allows.  K3 and K6c take it alike, so K6c stays bitwise K3 on
    the masked decode."""
    side, depth = gram_tile(c)
    nt = _cdiv(c, side)
    want = _cdiv(GRAM_BLOCKS_PER_SM * sms, g * nt * (nt + 1) // 2)
    chunk = max(depth, n // want // depth * depth)
    return _cdiv(n, chunk), chunk


def sm_count(device):
    """The SM count of a CUDA device, which sizes ``gram_split``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def combine_plan(c, n, mode):
    """(path, vec, bucket) of the combine at (C, N) in ``mode``, as
    ``launch_combine`` in ``csrc/robust_pipeline.cuh`` picks it for aligned
    tensors: a thread owns ``vec`` consecutive columns, the widest of 4, 2
    and 1 that divides N (each row starts N floats after the last, so its
    vector loads stay aligned).  ``mean`` streams the rows (``stream``);
    trimmed and median rank each column from registers over a bucket of
    16 (vec <= 2), 32 or 64 rows (vec 1) (``registers``), and past 64 rows
    from the (C, COMBINE_THREADS) shared tile, one column a thread
    (``tile``)."""
    vec = 4 if n % 4 == 0 else 2 if n % 2 == 0 else 1
    if mode == "mean":
        return "stream", vec, 0
    for bucket in (16, 32, 64):
        if c <= bucket:
            return "registers", min(vec, 2) if bucket == 16 else 1, bucket
    return "tile", 1, 0


def combine_smem_bytes(c, n, mode):
    """Dynamic shared memory of the combine's block: only the tile path
    has any (the (C, COMBINE_THREADS) tile and the mask)."""
    if combine_plan(c, n, mode)[0] != "tile":
        return 0
    return 4 * (c * COMBINE_THREADS + c)


def check_combine_smem(c, n, mode):
    """Raises where the combine's block at (C, N) would exceed shared
    memory (trimmed or median past about 450 rows)."""
    if combine_smem_bytes(c, n, mode) > SMEM_LIMIT:
        raise ValueError(f"C={c}: the (C, {COMBINE_THREADS}) tile exceeds "
                         "shared memory")


def pass1_plan(c, n):
    """(path, bucket, vec, nblk) of pass 1 (K1 / K4a / K6a) at (C, N), as
    ``launch_pass1`` in ``csrc/robust_pipeline.cuh`` picks it: for C <= 64
    a thread owns ``vec`` consecutive columns (2 in the 16-row bucket when
    N is even, else 1) and ranks them from registers over the combine's
    bucket of 16, 32 or 64 rows (``registers``), vec * PASS1_THREADS
    columns a block; past 64 rows one column a thread from the (C,
    PASS1_TILE_COLS) shared tile (``tile``).  Each of the ``nblk`` blocks
    writes one row of partials; there is no other split.  The plan depends
    on (C, N) alone, not on the row source, the tensors' alignment (an
    unaligned matrix keeps the plan and loads its vectors element by
    element), G or the card, so K6a adds its sums in K1's order."""
    bucket = next((b for b in (16, 32, 64) if c <= b), 0)
    vec = 2 if bucket == 16 and n % 2 == 0 else 1
    cols = vec * PASS1_THREADS if bucket else PASS1_TILE_COLS
    return "registers" if bucket else "tile", bucket, vec, _cdiv(n, cols)


def pass1_smem_bytes(c, n):
    """Dynamic shared memory of a pass-1 block: the (C, cols) tile and the
    median row, plus the mask on the tile path."""
    path, _, vec, _ = pass1_plan(c, n)
    if path == "tile":
        return 4 * (c * PASS1_TILE_COLS + PASS1_TILE_COLS + c)
    return 4 * (c + 1) * vec * PASS1_THREADS


def check_pass1_smem(c, n):
    """Raises where a pass-1 block at (C, N) would exceed shared memory
    (past about 450 rows)."""
    if pass1_smem_bytes(c, n) > SMEM_LIMIT:
        raise ValueError(f"C={c}: the (C, {PASS1_TILE_COLS}) tile exceeds "
                         "shared memory")


def _dispatch(x):
    """True where the kernel launches (CUDA tensors), False where the plain
    version runs (CPU ones); raises on a fake tensor or another device
    (``device.plain_route``)."""
    return not device.plain_route(_segs(x)[0])


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the card's yardstick of correctness)
# ---------------------------------------------------------------------------

def _col_blocks(x, chunk):
    """(start, block) over the columns of ``x`` (``_segs``) in steps of
    ``chunk``: a (G, C, <= chunk) view of one leaf, or, where a step spans
    leaves, their pieces joined (at most ``chunk`` columns).  The blocks
    hold what the concatenated matrix's would, so the sums over them are
    its sums."""
    segs = _segs(x)
    off = _offsets(segs)
    for s in range(0, off[-1], chunk):
        e = min(s + chunk, off[-1])
        parts = [t[:, :, max(s, a) - a:min(e, b) - a]
                 for t, a, b in zip(segs, off, off[1:]) if a < e and b > s]
        yield s, parts[0] if len(parts) == 1 else torch.cat(parts, -1)


def _median_cols(x, m, n):
    """Masked coordinate median of a fp32 (G, C, n_cols) block, as the TPU
    kernel's ``_median_block``: rows ranked lo and hi, picked and summed."""
    rank = stable_ranks(torch.where(m > 0, x, _BIG))
    lo = torch.floor((n - 1.0) / 2.0)
    hi = torch.ceil((n - 1.0) / 2.0)
    pick_lo = (rank == lo).float() * m
    pick_hi = (rank == hi).float() * m
    return 0.5 * ((x * pick_lo).sum(1, keepdim=True)
                  + (x * pick_hi).sum(1, keepdim=True))      # (G, 1, n)


def cosine_gate_partials_plain(x, mask, *, chunk=PLAIN_CHUNK):
    G, C, N = dims(x)
    dev = _segs(x)[0].device
    m = mask.float()[:, :, None]
    n = m.sum(1, keepdim=True)
    dots = torch.zeros(G, C, device=dev)
    sqn = torch.zeros(G, C, device=dev)
    refsq = torch.zeros(G, 1, device=dev)
    for _, xc in _col_blocks(x, chunk):
        xc = xc.float()
        med = _median_cols(xc, m, n)
        dots += (xc * med).sum(-1)
        sqn += (xc * xc).sum(-1)
        refsq += (med * med).sum(-1)
    return dots, sqn, refsq


def gated_combine_plain(x, gated_mask, weights, *, mode, trim_frac=0.2,
                        chunk=PLAIN_CHUNK):
    G, C, N = dims(x)
    m = gated_mask.float()[:, :, None]
    w = weights.float()[:, :, None]
    n = m.sum(1, keepdim=True)
    out = torch.empty(G, N, device=_segs(x)[0].device)
    for s, xc in _col_blocks(x, chunk):
        xc = xc.float()
        if mode == "mean":
            r = (xc * w).sum(1)
        elif mode == "median":
            r = _median_cols(xc, m, n)[:, 0]
        elif mode == "trimmed":
            rank = stable_ranks(torch.where(m > 0, xc, _BIG))
            t = torch.floor(trim_frac * n)
            keep = ((rank >= t) & (rank < n - t)).float() * m
            r = (xc * keep).sum(1) / torch.clamp(n - 2.0 * t, min=1.0)[:, 0]
        else:
            raise ValueError(mode)
        out[:, s:s + xc.shape[-1]] = r
    return out


def pairwise_gram_plain(x, *, chunk=PLAIN_CHUNK):
    G, C, N = dims(x)
    gram = torch.zeros(G, C, C, device=_segs(x)[0].device)
    for _, xc in _col_blocks(x, chunk):
        xc = xc.float()
        gram += xc @ xc.transpose(1, 2)
    return gram


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def launch_pass1(fn, ptrs, dims, device):
    """Launches pass 1, ``rp_pass1`` (K1 / K4a) or ``cc_pass1`` (K6a), on
    its input pointers ``ptrs`` and sizes ``dims`` (G, C, N, ...), with the
    scratch of ``pass1_plan`` -> (dots, sqnorms, refsq)."""
    G, C, N = dims[:3]
    check_pass1_smem(C, N)
    nblk = pass1_plan(C, N)[3]
    part = torch.empty(G, nblk, 2 * C + 1, device=device)
    out = torch.empty(G, 2 * C + 1, device=device)
    _launch(fn, *ptrs, part.data_ptr(), out.data_ptr(), *dims, nblk)
    return out[:, :C], out[:, C:2 * C], out[:, 2 * C:]


def _source(x, dense, seg):
    """(entry point, leading arguments) that read ``x`` (``_segs``): the
    dense one on one matrix, the *_seg one through a segment table (held
    in the arguments' owner, returned third)."""
    segs = _segs(x)
    lib = _build.load()
    if len(segs) == 1:
        return getattr(lib, dense), (segs[0].data_ptr(),), None
    table = _Table(segs)
    return getattr(lib, seg), table.args, table


def _pass1(x, mask, wrapper):
    """rp_pass1 on CUDA tensors (counted on ``wrapper``), the plain
    version on CPU ones."""
    if not _dispatch(x):
        return cosine_gate_partials_plain(x, mask)
    (mask,) = _check_cuda(x, mask)
    fn, args, _table = _source(x, "rp_pass1", "rp_pass1_seg")
    out = launch_pass1(fn, (*args, mask.data_ptr()), dims(x),
                       mask.device)
    wrapper.launches += 1
    return out


def _combine(x, gated_mask, weights, mode, trim_frac, wrapper):
    """rp_combine on CUDA tensors (counted by mode on ``wrapper``), the
    plain version on CPU ones."""
    if mode not in MODES:
        raise ValueError(mode)
    if not _dispatch(x):
        return gated_combine_plain(x, gated_mask, weights, mode=mode,
                                   trim_frac=trim_frac)
    gated_mask, weights = _check_cuda(x, gated_mask, weights)
    G, C, N = dims(x)
    check_combine_smem(C, N, mode)
    out = torch.empty(G, N, device=weights.device)
    fn, args, _table = _source(x, "rp_combine", "rp_combine_seg")
    _launch(fn, *args, gated_mask.data_ptr(), weights.data_ptr(),
            out.data_ptr(), G, C, N, COMBINE_THREADS, MODES[mode],
            float(trim_frac))
    wrapper.launches[mode] += 1
    return out


def _gram(x, wrapper):
    """rp_gram on CUDA tensors (counted on ``wrapper``), the plain version
    on CPU ones."""
    if not _dispatch(x):
        return pairwise_gram_plain(x)
    _check_cuda(x)
    G, C, N = dims(x)
    dev = _segs(x)[0].device
    nsplit, chunk = gram_split(G, C, N, sm_count(dev))
    part = torch.empty(G, nsplit, C * C, device=dev)
    out = torch.empty(G, C, C, device=dev)
    fn, args, _table = _source(x, "rp_gram", "rp_gram_seg")
    _launch(fn, *args, part.data_ptr(), out.data_ptr(), G, C, N, chunk)
    wrapper.launches += 1
    return out


def cosine_gate_partials(x, mask):
    """K1.  x: (G, C, N), or a list of (G, C, n_l) leaves side by side
    (read in place through a segment table, as their concatenation),
    mask: (G, C) 0/1 -> (dots (G, C), sqnorms (G, C), refsq (G, 1)): the
    per-client cosine partials against the masked coordinate median, in
    one read of x.

    Replaces ``repro/kernels/robust_pipeline.py:cosine_gate_partials_leafwise``.
    Bound: bytes (one read of x; the C^2 compares per column stay under
    it on the fp32 units at C = 16).  Design (``pass1_plan``): for C <= 64
    a thread loads its 1 or 2 columns' C values once, with vector loads,
    and ranks them from registers as K2's median does (bitwise the same
    median); the values also go to a shared tile, from which each block
    adds its 2C + 1 row sums in a fixed order; past 64 rows a (C, 128)
    shared tile, one column a thread.  The per-block partials are summed
    in a fixed order by a second launch.
    """
    return _pass1(x, mask, cosine_gate_partials)


def gated_combine(x, gated_mask, weights, *, mode, trim_frac=0.2):
    """K2.  x: (G, C, N) or leaves side by side, as K1's; gated_mask: (G,
    C); weights: (G, C), normalised, read by ``mean`` only -> (G, N) fp32.
    ``mode``: mean | trimmed | median.

    Replaces ``repro/kernels/robust_pipeline.py:gated_combine_leafwise``.
    Bound: bytes (one read of x, one write of the row).  Design: a thread
    owns 1, 2 or 4 consecutive columns in registers (``combine_plan``):
    ``mean`` streams the rows with vector loads; trimmed and median load
    each column's C values once and rank them from registers (C <= 64),
    else from a (C, 128) shared tile.  ``.launches`` counts by mode.
    """
    return _combine(x, gated_mask, weights, mode, trim_frac, gated_combine)


def pairwise_gram(x):
    """K3.  x: (G, C, N) or leaves side by side, as K1's -> the Gram
    matrix X X^T (G, C, C) in fp32 FMA (not TF32).

    Replaces ``repro/kernels/robust_pipeline.py:pairwise_sq_dists_leafwise``
    (its Gram accumulation; the distances are formed in torch).  Bound:
    bytes at C = 16 (one read of x), operations on the fp32 units past
    C ~ 50 (C(C+1) flops per column, the symmetric half).  Design: each
    block of 64 threads accumulates one output tile of the upper triangle
    (16 x 16 for C <= 16, else 32 x 32) over its column chunk and mirrors
    it, so any C runs; each thread holds a 2 x 2 or 4 x 4 register
    micro-tile fed by float4 reads of double-buffered (cp.async) stages,
    one fmaf chain an output in column order; ``gram_split`` sizes the
    chunks to fill the card, and the partials are summed in a fixed order
    by a second launch.
    """
    return _gram(x, pairwise_gram)


def cosine_gate_partials_flat(x, mask):
    """K4a, the flat pass 1: ``cosine_gate_partials`` (K1, ``rp_pass1``)
    behind its own launch counter.

    Replaces ``repro/kernels/robust_pipeline.py:cosine_gate_partials``.
    The TPU's flat form takes a pre-flattened, blk-padded (G, C, N)
    matrix; K1 here already does, and takes any N."""
    return _pass1(x, mask, cosine_gate_partials_flat)


def gated_combine_flat(x, gated_mask, weights, *, mode, trim_frac=0.2):
    """K4b, the flat pass 2: ``gated_combine`` (K2, ``rp_combine``) behind
    its own launch counter (by mode).

    Replaces ``repro/kernels/robust_pipeline.py:gated_combine``."""
    return _combine(x, gated_mask, weights, mode, trim_frac,
                    gated_combine_flat)


def pairwise_sq_dists_blocked(x, mask):
    """K4c.  x: (G, C, N), mask: (G, C) -> (G, C, C) squared distances
    from K3's Gram (``rp_gram``, counted here), masked pairs pushed to
    +1e30: the contract of ``repro/kernels/robust_pipeline.py:
    pairwise_sq_dists_blocked``.  The diagonal is exactly 0 (the norms
    are the Gram's diagonal), where the TPU kernel gives a rounding-level
    value."""
    return sq_dists_from_gram(_gram(x, pairwise_sq_dists_blocked),
                              mask.float())


def reset_launch_counts():
    for fn in (cosine_gate_partials, pairwise_gram, cosine_gate_partials_flat,
               pairwise_sq_dists_blocked):
        fn.launches = 0
    for fn in (gated_combine, gated_combine_flat):
        fn.launches = {m: 0 for m in MODES}


def _counts(pass1, combine, gram):
    out = {pass1.__name__: pass1.launches, gram.__name__: gram.launches}
    for m, n in combine.launches.items():
        out[f"{combine.__name__}[{m}]"] = n
    return out


def launch_counts():
    """{kernel name: launches since the last reset} of K1-K3."""
    return _counts(cosine_gate_partials, gated_combine, pairwise_gram)


def flat_launch_counts():
    """{kernel name: launches since the last reset} of the flat wrappers
    K4a-c."""
    return _counts(cosine_gate_partials_flat, gated_combine_flat,
                   pairwise_sq_dists_blocked)


reset_launch_counts()


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def sq_dists_from_gram(gram, mask):
    """(G, C, C) squared distances from a Gram matrix; masked pairs pushed
    to +_BIG (the contract of ``aggregation.pairwise_sq_dists``)."""
    sqn = torch.diagonal(gram, dim1=1, dim2=2)
    d = sqn[:, :, None] + sqn[:, None, :] - 2.0 * gram
    big = _BIG * (1.0 - mask[:, :, None] * mask[:, None, :])
    return torch.clamp(d, min=0.0) + big


def pairwise_sq_dists(x, mask):
    """(G, C, C) squared distances from the K3 Gram."""
    return sq_dists_from_gram(pairwise_gram(x), mask)


def _krum_weights(d, mask, f, multi_m):
    """Krum selection weights from (G, C, C) distances (mirrors
    ``aggregation.krum``): score = sum of the n-f-2 smallest distances,
    the multi_m best averaged, winners only among masked-in clients."""
    C = d.shape[1]
    d = d + _BIG * torch.eye(C, device=d.device)[None]
    n = mask.sum(1, keepdim=True)
    closest = torch.sort(d, dim=2).values
    j = torch.arange(C, dtype=torch.float32, device=d.device)[None, None, :]
    take = torch.clamp(n - f - 2, min=1.0)[:, :, None]
    scores = torch.where(j < take, closest, 0.0).sum(2)
    scores = torch.where(mask > 0, scores,
                         torch.full_like(scores, float("inf")))
    pos = torch.argsort(torch.argsort(scores, dim=1, stable=True), dim=1,
                        stable=True)
    sel = (pos < multi_m).float() * (mask > 0)
    return sel / torch.clamp(sel.sum(1, keepdim=True), min=1e-12)


def _resolve_gate(dots, sqn, refsq, mask, cosine_thresh):
    """Cosine outlier gate from the pass-1 partials; never gates everyone
    out, and an incoming all-zero row passes through unchanged."""
    cos = dots / torch.clamp(torch.sqrt(sqn * refsq), min=1e-12)
    m = mask * ((cos >= cosine_thresh) & (mask > 0)).float()
    return torch.where(m.sum(1, keepdim=True) > 0, m, mask)


def eq11(partials, combine, gram, weights, mask, *, aggregator, trim_frac,
         cosine_thresh, krum_f, krum_multi_m=1):
    """The Eq.-11 pipeline over one kernel family: ``partials(mask)`` is
    pass 1, ``combine(mask, weights, mode, trim_frac)`` pass 2 and
    ``gram(mask)`` Krum's Gram (multi-Krum: the ``krum_multi_m`` best
    averaged).  Weights and mask (G, C) -> (G, N) fp32."""
    mask = mask.float()
    m = _resolve_gate(*partials(mask), mask, cosine_thresh)
    if aggregator == "fedavg":
        w = weights * m
        w = w / torch.clamp(w.sum(1, keepdim=True), min=1e-12)
        return combine(m, w, "mean", trim_frac)
    if aggregator == "trimmed_mean":
        return combine(m, m, "trimmed", trim_frac)
    if aggregator == "median":
        return combine(m, m, "median", trim_frac)
    if aggregator == "krum":
        w = _krum_weights(sq_dists_from_gram(gram(m), m), m, krum_f,
                          krum_multi_m)
        return combine(m, w, "mean", trim_frac)
    raise ValueError(aggregator)


def eq11_sharded(parts, counted, reduce, weights, mask, *, pass1, combine,
                 gram, aggregator, trim_frac, cosine_thresh, krum_f):
    """The Eq.-11 pipeline over one rank's column parts of a matrix whose
    columns are spread over the ranks of a mesh: the distribution hook of
    the JAX package's ``fused_pipeline_leafwise(axis_name=, leaf_scale=)``.

    ``parts``: the rank's (G, C, n_p) inputs of ``pass1(part, mask)``,
    ``combine(part, mask, weights, mode, trim_frac)`` and ``gram(part, mask)``
    (one kernel family).  Pass 1's (G, 2C + 1) partials, summed over the
    parts whose ``counted`` flag is set, are summed over the ranks by
    ``reduce`` (an in-place all-reduce) between pass 1 and the gate, and
    so is Krum's Gram matrix: a part held whole by every rank is counted on
    one of them only (JAX's 0/1 ``leaf_scale``).  The kernels themselves do
    not change.  Returns the (G, n_p) output of every part."""
    G, C = mask.shape

    def summed(fn, width, m):
        acc = None
        for part, c in zip(parts, counted):
            if c:
                v = fn(part, m)
                acc = v if acc is None else acc + v
        if acc is None:
            acc = torch.zeros(G, *width, device=mask.device)
        return reduce(acc)

    def partials(m):
        acc = summed(lambda p, mm: torch.cat(pass1(p, mm), 1), (2 * C + 1,), m)
        return acc[:, :C], acc[:, C:2 * C], acc[:, 2 * C:]

    return eq11(
        partials,
        lambda m, w, mode, tf: [combine(p, m, w, mode, tf) for p in parts],
        lambda m: summed(gram, (C, C), m),
        weights, mask, aggregator=aggregator, trim_frac=trim_frac,
        cosine_thresh=cosine_thresh, krum_f=krum_f)


def fused_pipeline_sharded(parts, weights, mask, *, counted, reduce,
                           aggregator="trimmed_mean", trim_frac=0.2,
                           cosine_thresh=-0.5, krum_f=1):
    """``eq11_sharded`` through K1-K3 over fp32 (G, C, n_p) parts."""
    return eq11_sharded(
        parts, counted, reduce, weights, mask,
        pass1=lambda x, m: _pass1(x, m, cosine_gate_partials),
        combine=lambda x, m, w, mode, tf: _combine(x, m, w, mode, tf,
                                                   gated_combine),
        gram=lambda x, m: _gram(x, pairwise_gram), aggregator=aggregator,
        trim_frac=trim_frac, cosine_thresh=cosine_thresh, krum_f=krum_f)


def fused_pipeline(x, weights, mask, *, aggregator="trimmed_mean",
                   trim_frac=0.2, cosine_thresh=-0.5, krum_f=1,
                   krum_multi_m=1, flat=False):
    """Full Eq.-11 pipeline over a cohort batch x (G, C, N), or its leaves
    side by side (K1's ``x``), with weights and mask (G, C) -> (G, N) fp32
    aggregated rows, through K1-K3
    (``krum_multi_m``: multi-Krum's count of averaged winners).  With
    ``flat`` the launches are counted on the flat wrappers K4a-c (the
    counterpart of ``repro/kernels/robust_pipeline.py:fused_pipeline``):
    the same kernels, so the same result bit for bit."""
    pass1, combine, gram = (
        (cosine_gate_partials_flat, gated_combine_flat,
         pairwise_sq_dists_blocked) if flat
        else (cosine_gate_partials, gated_combine, pairwise_gram))
    return eq11(
        lambda m: _pass1(x, m, pass1),
        lambda m, w, mode, tf: _combine(x, m, w, mode, tf, combine),
        lambda m: _gram(x, gram), weights, mask, aggregator=aggregator,
        trim_frac=trim_frac, cosine_thresh=cosine_thresh, krum_f=krum_f,
        krum_multi_m=krum_multi_m)


def _pipeline_args(cfg):
    return dict(aggregator=cfg.aggregator, trim_frac=cfg.trim_frac,
                cosine_thresh=cfg.cosine_outlier_thresh, krum_f=cfg.krum_f)


def _split(out, updates, lead):
    """Per-leaf views of the (N,) row ``out``, each cast to its leaf's
    dtype, in the structure of ``updates`` behind its ``lead`` axes."""
    like = tree.map(lambda l: l[(0,) * lead], updates)
    return tree.map(lambda o, l: o.to(l.dtype), tree.row_views(out, like),
                    like)


def _cross_slot(per, slot_masks):
    """The two-stage scheme's second stage: the (G, N) cohort rows
    weighted by each cohort's masked-in size."""
    cw = slot_masks.float().sum(1)
    cw = cw / torch.clamp(cw.sum(), min=1e-12)
    return torch.tensordot(cw, per, dims=1)


def _leaf_matrices(updates, lead):
    """Each leaf of ``updates`` (``lead`` = 1: (C, ...), 2: (G, C, ...)) as
    a fp32 (G, C, n) matrix: a view of a contiguous fp32 leaf, a cast
    copy of another dtype."""
    return [l.reshape(*((1,) * (2 - lead)), *l.shape[:lead], -1).float()
            .contiguous() for l in tree.leaves(updates)]


def fused_aggregate_tree(updates, weights, mask, cfg, *, flat=False):
    """Single-cohort Eq.-11 aggregation of a tree of (C, ...) leaves of any
    float dtype; the counterpart of ``aggregation.aggregate_ref``.  The
    leaves stream in place, side by side (the round's one-leaf (C, N)
    buffer as one matrix, several leaves through the segment table), so
    the result is bitwise that of their concatenation.  Each output leaf
    is cast to its dtype once.  ``flat``: as in ``fused_pipeline``."""
    out = fused_pipeline(_leaf_matrices(updates, 1), weights[None],
                         mask[None], flat=flat, **_pipeline_args(cfg))[0]
    return _split(out, updates, 1)


def fused_aggregate_tree_flat(updates, weights, mask, cfg):
    """``fused_aggregate_tree`` counted on K4a-c: the counterpart of
    ``repro/kernels/robust_pipeline.py:fused_aggregate_tree_flat``."""
    return fused_aggregate_tree(updates, weights, mask, cfg, flat=True)


def fused_two_stage_tree(slot_updates, slot_weights, slot_masks, cfg, *,
                         flat=False):
    """Cohort-batched two-stage scheme over a tree of (G, C, ...) leaves:
    every cohort rides the G axis of one K1-K3 pipeline (the leaves side
    by side, as in ``fused_aggregate_tree``), then the cross-slot mean
    weighted by cohort size, in fp32, one cast a leaf.  ``flat``: as in
    ``fused_pipeline``."""
    per = fused_pipeline(_leaf_matrices(slot_updates, 2), slot_weights,
                         slot_masks, flat=flat, **_pipeline_args(cfg))
    return _split(_cross_slot(per, slot_masks), slot_updates, 2)


def fused_two_stage_tree_flat(slot_updates, slot_weights, slot_masks, cfg):
    """``fused_two_stage_tree`` counted on K4a-c: the counterpart of
    ``repro/kernels/robust_pipeline.py:fused_two_stage_tree_flat``."""
    return fused_two_stage_tree(slot_updates, slot_weights, slot_masks, cfg,
                                flat=True)
