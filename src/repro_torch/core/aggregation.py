"""Robust, trust-aware aggregation A(.) of per-client updates (paper
Eq. 11) — port of ``repro/core/aggregation.py``.

Updates are trees whose leaves carry a leading client axis (K, ...).
Every aggregator takes a float mask (K,) — only masked-in clients count.

  fedavg        weighted mean
  median        coordinate-wise masked median
  trimmed_mean  coordinate-wise masked trimmed mean
  krum          (multi-)Krum by pairwise distances

plus the trust machinery (EWMA trust, gradient-cosine outlier gating) and
the aggregation-boundary guard.  ``aggregate`` runs the Eq.-11 pipeline
through the fused CUDA kernels (``kernels/robust_pipeline.py``) unless
``cfg.fused_agg`` is False; the multi-pass plain-torch functions here are
the reference (``aggregate_ref``).  Empty cohorts give a zero update and a
lone Krum survivor passes through, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch import tree

_BIG = 1e30


def _rows(leaf):
    return leaf.reshape(leaf.shape[0], -1).float()


def _bcast(v, leaf):
    """(K,) -> broadcastable against a (K, ...) leaf."""
    return v.reshape((leaf.shape[0],) + (1,) * (leaf.dim() - 1))


def normalize_weights(weights, mask):
    w = weights * mask
    return w / torch.clamp(w.sum(), min=1e-12)


def _lo_hi(n):
    """Middle rank indices of n sorted entries, clamped to n >= 1."""
    h = torch.clamp(n - 1, min=0) / 2
    return torch.floor(h).long(), torch.ceil(h).long()


def _take(s, i):
    """s[i] along axis 0 for a 0-d index tensor, without a host sync."""
    return s.index_select(0, i.reshape(1))[0]


def _guard(updates, mask, norm_mult):
    """The guard's two rules on each client row: ``(finite, sane)`` (K,)
    bools, ``sane`` None when the norm rule is off.  The median's middle
    ranks are taken on the device by a gather, with no host read."""
    k = mask.shape[0]
    finite = torch.ones(k, dtype=torch.bool, device=mask.device)
    sq = torch.zeros(k, device=mask.device)
    for leaf in tree.leaves(updates):
        f = _rows(leaf)
        ok = torch.isfinite(f)
        finite = finite & ok.all(dim=1)
        sq = sq + torch.sum(torch.where(ok, f, 0.0) ** 2, dim=1)
    if not (norm_mult and norm_mult > 0):
        return finite, None
    norm = torch.sqrt(sq)
    good = finite & (mask > 0)
    s = torch.sort(torch.where(good, norm,
                               torch.full_like(norm, float("inf")))).values
    n_good = good.sum()
    lo, hi = _lo_hi(n_good)
    med = 0.5 * (_take(s, lo) + _take(s, hi))
    med = torch.where(n_good > 0, med, torch.zeros_like(med))
    return finite, norm <= norm_mult * torch.clamp(med, min=1e-12)


def _clean(updates, mask, finite, sane):
    ok_row = finite if sane is None else finite & sane
    rejected = ((mask > 0) & ~ok_row).float()
    okf = ok_row.float()
    clean = tree.map(
        lambda l: torch.where(_bcast(okf, l) > 0, l, torch.zeros_like(l)),
        updates)
    return clean, mask * okf, rejected


def _kinds(mask, finite, sane):
    in_mask = mask > 0
    nonfinite = (in_mask & ~finite).float()
    if sane is None:
        return nonfinite, torch.zeros_like(nonfinite)
    return nonfinite, (in_mask & finite & ~sane).float()


def sanitize_updates(updates, mask, *, norm_mult=1e4):
    """Reject non-finite or absurd-norm client deliveries before any
    aggregator sees them: a masked-in row is rejected if any coordinate is
    non-finite, or (``norm_mult`` > 0) if its tree-wide L2 norm exceeds
    ``norm_mult`` x the masked median norm of the finite rows.  Returns
    ``(clean_updates, clean_mask, rejected)``; rejected rows are zeroed and
    masked out.  Sane inputs pass through bit-identical."""
    return _clean(updates, mask, *_guard(updates, mask, norm_mult))


def rejection_kinds(updates, mask, *, norm_mult=1e4):
    """Telemetry readout of the guard's decision split by kind: ``(nonfinite,
    norm)`` 0/1 (K,) vectors with ``nonfinite + norm`` equal to
    ``sanitize_updates``' ``rejected`` on the same inputs (a row failing
    both counts as nonfinite: that rule fires first)."""
    return _kinds(mask, *_guard(updates, mask, norm_mult))


def sanitize_with_kinds(updates, mask, *, norm_mult=1e4):
    """``sanitize_updates`` and ``rejection_kinds`` of the same inputs from
    one pass of the guard's reductions (the JAX round leaves that sharing
    to XLA's common-subexpression elimination): ``(clean_updates,
    clean_mask, rejected, nonfinite, norm)``."""
    finite, sane = _guard(updates, mask, norm_mult)
    return (*_clean(updates, mask, finite, sane),
            *_kinds(mask, finite, sane))


def weighted_mean(updates, weights, mask):
    w = normalize_weights(weights, mask)
    return tree.map(lambda l: torch.tensordot(w.to(l.dtype), l, dims=1),
                    updates)


def _masked_sorted(leaf, mask):
    """Sort clients per coordinate, masked-out clients pushed to _BIG."""
    xm = torch.where(_bcast(mask, leaf) > 0, leaf.float(),
                     torch.full_like(leaf, _BIG, dtype=torch.float32))
    return torch.sort(xm, dim=0, stable=True).values


def median(updates, mask):
    """Coordinate-wise median over masked-in clients; an empty cohort
    gives a zero update."""
    n = mask.sum()
    lo, hi = _lo_hi(n)

    def agg(leaf):
        s = _masked_sorted(leaf, mask)
        out = 0.5 * (_take(s, lo) + _take(s, hi))
        return torch.where(n > 0, out, torch.zeros_like(out)).to(leaf.dtype)

    return tree.map(agg, updates)


def trimmed_mean(updates, mask, trim_frac):
    """Coordinate-wise mean after dropping trim_frac per side (of n)."""
    n = mask.sum()
    t = torch.floor(trim_frac * n)

    def agg(leaf):
        s = _masked_sorted(leaf, mask)
        k = leaf.shape[0]
        idx = _bcast(torch.arange(k, device=leaf.device), leaf)
        keep = (idx >= t) & (idx < n - t)
        cnt = torch.clamp(n - 2 * t, min=1.0)
        return (torch.where(keep, s, 0.0).sum(0) / cnt).to(leaf.dtype)

    return tree.map(agg, updates)


def pairwise_sq_dists(updates, mask):
    """(K, K) squared distances between flattened client updates; masked
    pairs pushed to +_BIG."""
    d = 0.0
    for leaf in tree.leaves(updates):
        f = _rows(leaf)
        sq = torch.sum(f * f, dim=1)
        d = d + (sq[:, None] + sq[None, :] - 2.0 * (f @ f.T))
    big = _BIG * (1 - mask[:, None] * mask[None, :])
    return torch.clamp(d, min=0.0) + big


def krum(updates, mask, f, *, multi_m=1):
    """(Multi-)Krum [Blanchard et al. 2017]: score = sum of the n - f - 2
    smallest distances to the other selected clients; mean of the multi_m
    best.  Winners are restricted to masked-in clients."""
    d = pairwise_sq_dists(updates, mask)
    k = d.shape[0]
    d = d + _BIG * torch.eye(k, device=d.device)
    n = mask.sum()
    closest = torch.sort(d, dim=1).values
    j = torch.arange(k, dtype=torch.float32, device=d.device)[None, :]
    take = torch.clamp(n - f - 2, min=1.0)
    scores = torch.where(j < take, closest, 0.0).sum(1)
    scores = torch.where(mask > 0, scores,
                         torch.full_like(scores, float("inf")))
    order = torch.argsort(scores, stable=True)
    sel = torch.zeros(k, device=d.device).index_fill_(0, order[:multi_m],
                                                      1.0) * mask
    return weighted_mean(updates, sel, sel)


def cosine_to_ref(updates, ref):
    """Tree-wide cosine similarity (K,) of each client's update vs. a
    reference direction tree."""
    dots = n1 = n2 = 0.0
    for leaf, rleaf in zip(tree.leaves(updates), tree.leaves(ref)):
        f = _rows(leaf)
        r = rleaf.reshape(-1).float()
        dots = dots + f @ r
        n1 = n1 + torch.sum(f * f, dim=1)
        n2 = n2 + torch.sum(r * r)
    return dots / torch.clamp(torch.sqrt(n1 * n2), min=1e-12)


def cosine_outlier_mask(updates, ref, mask, thresh):
    """0/1 (K,): masked-in clients whose cosine to ``ref`` is >= thresh."""
    cos = cosine_to_ref(updates, ref)
    return ((cos >= thresh) & (mask > 0)).float()


def update_trust(trust, scores, mask, decay):
    """EWMA trust: selected clients track their normalised score;
    unselected clients drift toward neutral 0.5."""
    smax = torch.clamp(torch.max(scores * mask), min=1e-12)
    norm_score = torch.clamp(scores / smax, 0.0, 1.0)
    upd = decay * trust + (1.0 - decay) * norm_score
    hold = decay * trust + (1.0 - decay) * 0.5
    return torch.where(mask > 0, upd, hold)


def aggregate_ref(updates, weights, mask, cfg):
    """Multi-pass reference of the Eq.-11 pipeline: median reference ->
    cosine gate (never gating everyone out) -> the configured
    aggregator."""
    ref = median(updates, mask)
    gate = cosine_outlier_mask(updates, ref, mask, cfg.cosine_outlier_thresh)
    m = mask * gate
    m = torch.where(m.sum() > 0, m, mask)
    if cfg.aggregator == "fedavg":
        return weighted_mean(updates, weights, m)
    if cfg.aggregator == "median":
        return median(updates, m)
    if cfg.aggregator == "trimmed_mean":
        return trimmed_mean(updates, m, cfg.trim_frac)
    if cfg.aggregator == "krum":
        return krum(updates, m, cfg.krum_f)
    raise ValueError(cfg.aggregator)


def aggregate(updates, weights, mask, cfg):
    """Dispatch on cfg.fused_agg: the fused kernels
    (``robust_pipeline.fused_aggregate_tree``) or ``aggregate_ref``."""
    if cfg.fused_agg:
        from repro_torch.kernels.robust_pipeline import fused_aggregate_tree
        return fused_aggregate_tree(updates, weights, mask, cfg)
    return aggregate_ref(updates, weights, mask, cfg)


def shard_axes(mesh, axes):
    """The mesh axes the aggregation shards over (default: every axis but
    "pod"), as a tuple."""
    if axes is None:
        axes = tuple(a for a in mesh.axis_names if a != "pod")
    return tuple(axes)


def tp_columns(n, mesh):
    """The ``collectives.ColumnShards`` of ``aggregate_tp``'s (C/D, n)
    matrix over the mesh's data axes: its first n - n mod D columns split
    into D blocks, the rest whole."""
    from repro_torch.sharding import collectives, dtensor, specs
    data = mesh.over(tuple(a for a in mesh.axis_names
                           if a in dtensor.DP_AXES))
    sizes = [s for s in (n - n % data.size, n % data.size) if s]
    _, flags = specs.client_flat_specs(sizes, data, data.axis_names)
    return collectives.ColumnShards(sizes, flags, data)


def aggregate_tp(split, whole, weights, mask, cfg, mesh):
    """The Eq.-11 aggregate of per-client grads taken on a tensor-parallel
    copy of the params (the pod step's per-client path on a placed state).
    Each rank holds the rows of its data index's C/D clients (client order
    is data index major) as two ``collectives.SendRows`` of n columns
    each, in the send layout of ``tp_columns(n, mesh)``: ``split``, this
    rank's pieces of the leaves split over "model" (they differ across the
    model ranks), and ``whole``, the leaves whole over "model" (the same
    on every model rank).  The pod step writes its grads there, so nothing
    is packed; a caller with leaf-order rows packs them by
    ``tp_columns(n, mesh).pack``.  Over the data axes one all_to_all each
    turns them into (C, n/D) column shards (``collectives.ColumnShards``;
    a remainder of fewer than D columns stays whole); each rank streams
    its shards through K1 and K2 (K3), and
    only the (C,) cosine partials and Krum's (C, C) Gram cross ranks, by
    one all-reduce each over the mesh, where the whole leaves count on the
    first model rank only.  Nothing else crosses the model axis.  Returns
    the aggregated rows of both matrices, (n,) each, whole over the data
    axes.  Equal to ``aggregate`` of the whole (C, N) matrix up to the
    order of the cross-rank sums."""
    from repro_torch.kernels import robust_pipeline as rp
    from repro_torch.sharding import collectives, dtensor

    dp = tuple(a for a in mesh.axis_names if a in dtensor.DP_AXES)
    model = tuple(a for a in mesh.axis_names if a not in dp)
    first_model = not model or mesh.index(model) == 0
    mats, parts = [], []
    for x, counted in ((split, True), (whole, first_model)):
        n = _width(x)
        if not n:
            continue
        cols = tp_columns(n, mesh)
        sh, rep = cols.to_columns(x)
        mats.append((cols, sh.shape[1], rep.shape[1]))
        parts += [(sh[None], counted),
                  (rep[None], counted and cols.mesh.rank == 0)]
    parts = [(x, c) for x, c in parts if x.shape[-1]]
    outs = rp.fused_pipeline_sharded(
        [x for x, _ in parts], weights[None], mask[None],
        counted=[c for _, c in parts],
        reduce=lambda t: collectives.all_reduce_sum(t, mesh),
        **rp._pipeline_args(cfg))
    outs = iter(o[0] for o in outs)
    res = []
    for cols, n_sh, n_rep in mats:
        out_sh = next(outs) if n_sh else weights.new_empty(0)
        out_rep = next(outs) if n_rep else weights.new_empty(0)
        got = cols.gather(out_sh, out_rep)
        res.append(got[0] if len(got) == 1 else torch.cat(got))
    empty = weights.new_empty(0)
    return tuple(res.pop(0) if width else empty
                 for width in (_width(split), _width(whole)))


def _width(x):
    """The columns of a ``collectives.SendRows``."""
    return x.send.shape[0] * x.send.shape[2] + x.rep.shape[1]


def aggregate_sharded(updates, weights, mask, cfg, mesh, axes=None, *,
                      like=None):
    """Mesh-sharded Eq.-11 aggregation: the port of
    ``repro/core/aggregation.py:aggregate_sharded``.

    The ``axes`` ranks (``Mesh.over``: the W ranks that share this rank's
    coordinates on the axes not named; all of them by default) shard the
    flat axis among themselves; the ranks at the other coordinates do the
    same work on the same rows, as the reference's ``shard_map`` replicates
    over the axes it does not name.  ``updates`` holds the rows of this
    rank's clients, C/W of the C (rank r of the W has clients r C/W to
    (r + 1) C/W - 1): a tree of (C/W, ...) leaves, or with ``like`` (the
    params tree) one (C/W, N) buffer whose columns are ``like``'s leaves in
    order (the pod step's whole rows).  ``weights`` and
    ``mask`` are the whole (C,) columns.  Each leaf's flattened axis shards
    over the W ranks where its size divides W
    (``specs.client_flat_specs``): the rows are copied once into the
    reshard's send layout (``ColumnShards.pack``; open in ROADMAP §3, as
    the pod step's producer writes leaf order here), the reshard
    (``ColumnShards.to_columns``: one all_to_all at W > 1, no copy) turns
    them into (C, n/W) column shards, and the body
    (``aggregate_columns``) aggregates them.  Returns the
    aggregate, shaped like ``like`` (default: ``updates`` without its
    client axis), each leaf in its dtype.  Equal to ``aggregate`` up to
    the order of the cross-rank sums; at W = 1, with every leaf split,
    bitwise."""
    from repro_torch.sharding import collectives, specs

    sub = mesh.over(shard_axes(mesh, axes))
    if like is None:
        like = tree.map(lambda l: l[0], updates)
        updates = [l.reshape(l.shape[0], -1) for l in tree.leaves(updates)]
    sizes = [l.numel() for l in tree.leaves(like)]
    _, flags = specs.client_flat_specs(sizes, sub, sub.axis_names)
    cols = collectives.ColumnShards(sizes, flags, sub)
    sh, rep = cols.to_columns(cols.pack(updates, torch.float32))
    return aggregate_columns(sh, rep, cols, weights, mask, cfg, like)


def aggregate_columns(sh, rep, cols, weights, mask, cfg, like):
    """The body of ``aggregate_sharded``, the counterpart of the JAX
    package's ``shard_map``: its input is the layout the reference's
    ``with_sharding_constraint`` asks of the producer.  ``sh`` (C, sum
    ``cols.sh_sizes``) holds every client's rows of this rank's column
    block of each split leaf, ``rep`` (C, sum ``cols.rep_sizes``) the
    leaves that stay whole.  Every rank streams only its shard through K1
    and K2 (K3); only the (C,) cosine partials and Krum's (C, C) Gram
    cross ranks (one all-reduce each), the whole leaves counting once, on
    the first rank; and each split leaf's aggregated block is all-gathered
    into its own (n,) row (``ColumnShards.gather``: no concatenation).
    Returns the aggregate shaped like ``like``, each leaf in its dtype."""
    from repro_torch.kernels import robust_pipeline as rp
    from repro_torch.sharding import collectives

    own = cols.mesh.rank == 0
    parts = [(x[None], c) for x, c in ((sh, True), (rep, own))
             if x.shape[1]]
    outs = rp.fused_pipeline_sharded(
        [x for x, _ in parts], weights[None], mask[None],
        counted=[c for _, c in parts],
        reduce=lambda t: collectives.all_reduce_sum(t, cols.mesh),
        **rp._pipeline_args(cfg))
    outs = [o[0] for o in outs]
    out_sh = outs.pop(0) if sh.shape[1] else sh.new_empty(0)
    rows = cols.gather(out_sh, outs[0] if outs else sh.new_empty(0))
    return tree.unflatten(like, [o.view(l.shape).to(l.dtype)
                                 for o, l in zip(rows, tree.leaves(like))])


def two_stage_ref(slot_updates, slot_weights, slot_masks, cfg):
    """Reference of the two-stage scheme over trees of (G, C, ...) leaves:
    ``aggregate_ref`` per cohort, then the cross-slot mean weighted by each
    cohort's masked-in size."""
    g = slot_masks.shape[0]
    per = [aggregate_ref(tree.map(lambda l: l[i], slot_updates),
                         slot_weights[i], slot_masks[i], cfg)
           for i in range(g)]
    cw = slot_masks.float().sum(1)
    cw = cw / torch.clamp(cw.sum(), min=1e-12)
    return tree.map(
        lambda *ls: torch.tensordot(cw.to(ls[0].dtype), torch.stack(ls),
                                    dims=1), *per)


def two_stage(slot_updates, slot_weights, slot_masks, cfg):
    """Slot-internal robust aggregation per cohort, then the cross-slot
    mean: every cohort rides the G axis of one fused kernel pipeline when
    ``cfg.fused_agg``, else ``two_stage_ref``."""
    if cfg.fused_agg:
        from repro_torch.kernels.robust_pipeline import fused_two_stage_tree
        return fused_two_stage_tree(slot_updates, slot_weights, slot_masks,
                                    cfg)
    return two_stage_ref(slot_updates, slot_weights, slot_masks, cfg)
