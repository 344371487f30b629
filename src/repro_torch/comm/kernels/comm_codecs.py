"""Fused dequant-into-aggregation for the int8 uplink — the port of
``repro/comm/kernels/comm_codecs.py`` onto hand-written CUDA kernels
(``csrc/comm_codecs.cu``).

The server aggregates straight from the wire record: int8 codes (G, C, N)
and fp32 scales (G, C, NQ) laid out by a ``codecs.WireLayout``.  Each pass
of the Eq.-11 pipeline has a K6 counterpart that dequantizes on load:

  K6a  ``dequant_gate_partials``   pass 1 (K1) from codes
  K6b  ``dequant_gated_combine``   pass 2 (K2) from codes, three modes
  K6c  ``dequant_pairwise_gram``   Krum's Gram (K3) from codes

The kernels are K1-K3 (``csrc/robust_pipeline.cuh``) with another row
source: a byte load, the column's scale by the leaf table, and the fp32
multiply ``q * s`` of ``codecs.quant_decode``.  A row whose mask is 0 loads
as 0, so a masked-out client whose scale is inf (a non-finite update)
cannot turn a weight-0 term into NaN.  The contract, on the card and in the
plain versions here, is

    K6x(q, s, layout, mask) == K1-K3(where(mask, decode(q, s), 0))  bitwise,

and the round's aggregate is bitwise that of decode-then-aggregate for
finite input: masked rows never reach the median, the gate or the
combine, and a masked Krum pair carries +1e30 either way.

Dispatch: as ``kernels/robust_pipeline.py``: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version.  Each wrapper
counts its launches.  On either device a wrapper takes only int8 codes
and fp32 scales that match the layout, and raises otherwise.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.kernels import _build, robust_pipeline as rp


def _check(q, s, layout, *small):
    if q.dtype != torch.int8:
        raise TypeError(f"the fused-dequant kernels take int8 codes, got "
                        f"{q.dtype}")
    if s.dtype != torch.float32:
        raise TypeError(f"the fused-dequant kernels take float32 scales, got "
                        f"{s.dtype}")
    if q.dim() != 3 or s.dim() != 3 or q.shape[:2] != s.shape[:2] \
            or (q.shape[2], s.shape[2]) != (layout.n, layout.n_scales):
        raise ValueError(f"codes {tuple(q.shape)} / scales {tuple(s.shape)} "
                         f"do not match the layout (N={layout.n}, "
                         f"NQ={layout.n_scales})")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("the fused-dequant kernels take contiguous codes "
                         "and scales")
    if q.shape[-1] >= 2 ** 31:
        raise ValueError(f"N = {q.shape[-1]} >= 2^31")
    return [x.to(device=q.device, dtype=torch.float32).contiguous()
            for x in small]


def _quant_args(q, s, layout, mask):
    G, C, N = q.shape
    return (q.data_ptr(), s.data_ptr(), layout.table(q.device).data_ptr(),
            mask.data_ptr()), (G, C, N, layout.n_scales, len(layout.sizes),
                               layout.qblk)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def dequant_masked(q, s, layout, mask):
    """(G, C, N) fp32 = where(mask, q * s[scale column], 0): the matrix the
    K6 kernels see."""
    x = q.float() * s.index_select(2, layout.scale_index(q.device))
    return torch.where(mask[:, :, None] > 0, x, 0.0)


def dequant_gate_partials_plain(q, s, layout, mask):
    return rp.cosine_gate_partials_plain(dequant_masked(q, s, layout, mask),
                                         mask)


def dequant_gated_combine_plain(q, s, layout, gated_mask, weights, *, mode,
                                trim_frac=0.2):
    return rp.gated_combine_plain(dequant_masked(q, s, layout, gated_mask),
                                  gated_mask, weights, mode=mode,
                                  trim_frac=trim_frac)


def dequant_pairwise_gram_plain(q, s, layout, mask):
    return rp.pairwise_gram_plain(dequant_masked(q, s, layout, mask))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def dequant_gate_partials(q, s, layout, mask):
    """K6a.  Codes q (G, C, N) int8, scales s (G, C, NQ) fp32, mask (G, C)
    -> (dots (G, C), sqnorms (G, C), refsq (G, 1)), as K1 on the masked
    decode.

    Replaces ``repro/comm/kernels/comm_codecs.py:dequant_gate_partials``.
    Bound: operations at the main path's shape (the C^2 compares per column
    and the dequant multiplies just outweigh one byte a code plus the
    scales, a quarter of K1's read).  Design: K1's kernel and plan
    (``robust_pipeline.pass1_plan``) with the int8 row source: one char2
    (or char) load of a row's codes, a scale load a column, the mask read
    once a row."""
    (mask,) = _check(q, s, layout, mask)
    if not rp._dispatch(q):
        return dequant_gate_partials_plain(q, s, layout, mask)
    ptrs, dims = _quant_args(q, s, layout, mask)
    out = rp.launch_pass1(_build.load().cc_pass1, ptrs, dims, q.device)
    dequant_gate_partials.launches += 1
    return out


def dequant_gated_combine(q, s, layout, gated_mask, weights, *, mode,
                          trim_frac=0.2):
    """K6b.  K2 from codes: (G, N) fp32 under the gated mask; ``mode``:
    mean | trimmed | median.

    Replaces ``repro/comm/kernels/comm_codecs.py:dequant_gated_combine``.
    Bound: bytes (the codes and scales read once, the row written once).
    Design: K2's kernel with the int8 row source.  ``.launches`` counts by
    mode."""
    if mode not in rp.MODES:
        raise ValueError(mode)
    gated_mask, weights = _check(q, s, layout, gated_mask, weights)
    if not rp._dispatch(q):
        return dequant_gated_combine_plain(q, s, layout, gated_mask, weights,
                                           mode=mode, trim_frac=trim_frac)
    ptrs, dims = _quant_args(q, s, layout, gated_mask)
    G, C, N = q.shape
    rp.check_combine_smem(C, N, mode)
    out = torch.empty(G, N, device=q.device)
    rp._launch(_build.load().cc_combine, *ptrs, weights.data_ptr(),
               out.data_ptr(), *dims, rp.COMBINE_THREADS, rp.MODES[mode],
               float(trim_frac))
    dequant_gated_combine.launches[mode] += 1
    return out


def dequant_pairwise_gram(q, s, layout, mask):
    """K6c.  The Gram matrix (G, C, C) of the masked decode, in fp32 FMA.

    Replaces ``repro/comm/kernels/comm_codecs.py:dequant_pairwise_sq_dists``
    (its Gram accumulation; the distances are formed in torch, by
    ``robust_pipeline.sq_dists_from_gram``).  Bound: operations (2 C^2
    flops a column outweigh the code bytes).  Design: K3's kernel with the
    int8 row source, its stages dequantized through registers (one scale
    lookup a column and stage) and its chunks from ``gram_split``."""
    (mask,) = _check(q, s, layout, mask)
    if not rp._dispatch(q):
        return dequant_pairwise_gram_plain(q, s, layout, mask)
    ptrs, dims = _quant_args(q, s, layout, mask)
    G, C, N = q.shape
    nsplit, chunk = rp.gram_split(G, C, N, rp.sm_count(q.device))
    part = torch.empty(G, nsplit, C * C, device=q.device)
    out = torch.empty(G, C, C, device=q.device)
    rp._launch(_build.load().cc_gram, *ptrs, part.data_ptr(), out.data_ptr(),
               *dims, chunk)
    dequant_pairwise_gram.launches += 1
    return out


def reset_launch_counts():
    dequant_gate_partials.launches = 0
    dequant_gated_combine.launches = {m: 0 for m in rp.MODES}
    dequant_pairwise_gram.launches = 0


def launch_counts():
    """{kernel name: launches since the last reset}."""
    out = {"dequant_gate_partials": dequant_gate_partials.launches,
           "dequant_pairwise_gram": dequant_pairwise_gram.launches}
    for m, n in dequant_gated_combine.launches.items():
        out[f"dequant_gated_combine[{m}]"] = n
    return out


reset_launch_counts()


# ---------------------------------------------------------------------------
# routing and the pipeline
# ---------------------------------------------------------------------------

def should_fuse(codec, cfg):
    """The routing predicate of the fused-dequant path: the int8 wire
    format, ``fused_agg`` and ``fused_dequant``.  The JAX package also
    checks that ``qblk`` tiles every TPU streaming block (``fusable``);
    here each column finds its scale through the leaf table, so no such
    condition exists, and ``agg_blk`` (the TPU block) is refused by
    ``fedfits.make_round``."""
    return (codec is not None and codec.name == "int8" and cfg.fused_agg
            and cfg.fused_dequant)


def fused_dequant_pipeline(q, s, layout, weights, mask, *,
                           aggregator="trimmed_mean", trim_frac=0.2,
                           cosine_thresh=-0.5, krum_f=1, krum_multi_m=1):
    """Full Eq.-11 pipeline over int8 codes (G, C, N) and scales (G, C, NQ)
    with weights and mask (G, C) -> (G, N) fp32, through K6a-c and the
    gate and Krum scoring of ``kernels/robust_pipeline.py``
    (``krum_multi_m``: multi-Krum's count of averaged winners)."""
    return rp.eq11(
        lambda m: dequant_gate_partials(q, s, layout, m),
        lambda m, w, mode, tf: dequant_gated_combine(
            q, s, layout, m, w, mode=mode, trim_frac=tf),
        lambda m: dequant_pairwise_gram(q, s, layout, m), weights, mask,
        aggregator=aggregator, trim_frac=trim_frac,
        cosine_thresh=cosine_thresh, krum_f=krum_f, krum_multi_m=krum_multi_m)


def fused_dequant_aggregate_tree(enc, layout, weights, mask, cfg, *, like):
    """Single-cohort Eq.-11 aggregation straight from an int8 record
    (``codecs.QuantLeaf`` over ``layout``): the drop-in for
    ``aggregation.aggregate`` on the decoded buffer.  ``like`` is the
    params tree that gives the output leaves' shapes and dtypes."""
    out = fused_dequant_pipeline(
        enc.q[None], enc.s[None], layout, weights[None], mask[None],
        aggregator=cfg.aggregator, trim_frac=cfg.trim_frac,
        cosine_thresh=cfg.cosine_outlier_thresh, krum_f=cfg.krum_f)[0]
    return tree.map(lambda o, l: o.to(l.dtype), tree.row_views(out, like),
                    like)


def fused_dequant_pipeline_sharded(parts, weights, mask, *, counted, reduce,
                                   aggregator="trimmed_mean", trim_frac=0.2,
                                   cosine_thresh=-0.5, krum_f=1):
    """``robust_pipeline.eq11_sharded`` through K6a-c over (q (G, C, n_p),
    s (G, C, nq_p), layout_p) parts: each rank streams only its code and
    scale columns, and only the (G, 2C + 1) partials and Krum's Gram cross
    the ranks."""
    return rp.eq11_sharded(
        parts, counted, reduce, weights, mask,
        pass1=lambda p, m: dequant_gate_partials(*p, m),
        combine=lambda p, m, w, mode, tf: dequant_gated_combine(
            *p, m, w, mode=mode, trim_frac=tf),
        gram=lambda p, m: dequant_pairwise_gram(*p, m),
        aggregator=aggregator, trim_frac=trim_frac,
        cosine_thresh=cosine_thresh, krum_f=krum_f)


def fused_dequant_aggregate_sharded(enc, layout, weights, mask, cfg, mesh, *,
                                    like, axes=None):
    """Mesh-sharded fused-dequant aggregation: the port of
    ``repro/comm/kernels/comm_codecs.py:fused_dequant_aggregate_sharded``,
    over the ``axes`` ranks as ``aggregation.aggregate_sharded`` (W below).

    ``enc`` is the int8 record of this rank's clients (``codecs.QuantLeaf``
    of (C/W, N) codes and (C/W, NQ) scales over ``layout``), ``like`` the
    params tree.  A leaf splits over the ``axes`` ranks where its size
    divides their count times the quant block (``align=qblk``), so each
    rank's code shard carries exactly its own scale columns: one
    all_to_all each moves the codes and the scales into (C, n/W) column
    shards (wire bytes, not fp32), every rank dequantizes and streams only
    its shard through K6a and K6b (K6c), only the partials and Krum's Gram
    cross ranks, and the (N,) result is all-gathered.  Leaves that do not
    split stay whole and count once, on the first rank."""
    from repro_torch.core.aggregation import shard_axes
    from repro_torch.sharding import collectives, specs

    sub = mesh.over(shard_axes(mesh, axes))
    qblk = layout.qblk
    _, flags = specs.client_flat_specs(layout.sizes, sub, sub.axis_names,
                                       align=qblk)
    cols = collectives.ColumnShards(layout.sizes, flags, sub)
    scols = collectives.ColumnShards(
        [-(-n // qblk) for n in layout.sizes], flags, sub)
    # the codec writes leaf order: each record packed once
    q_sh, q_rep = cols.to_columns(cols.pack(enc.q))
    s_sh, s_rep = scols.to_columns(scols.pack(enc.s))
    own = sub.rank == 0
    parts = [((q[None], s[None], layout.part(n)), c)
             for q, s, n, c in ((q_sh, s_sh, cols.sh_sizes, True),
                                (q_rep, s_rep, cols.rep_sizes, own)) if n]
    outs = fused_dequant_pipeline_sharded(
        [p for p, _ in parts], weights[None], mask[None],
        counted=[c for _, c in parts],
        reduce=lambda t: collectives.all_reduce_sum(t, sub),
        aggregator=cfg.aggregator, trim_frac=cfg.trim_frac,
        cosine_thresh=cfg.cosine_outlier_thresh, krum_f=cfg.krum_f)
    outs = [o[0] for o in outs]
    empty = q_sh.new_empty(0, dtype=torch.float32)
    out_sh = outs.pop(0) if cols.sh_sizes else empty
    rows = cols.gather(out_sh, outs[0] if outs else empty)
    return tree.unflatten(like, [o.view(l.shape).to(l.dtype)
                                 for o, l in zip(rows, tree.leaves(like))])
