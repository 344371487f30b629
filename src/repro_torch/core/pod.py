"""PodEngine: one FedFiTS round as one training step of a large model —
the port of ``repro/core/pod.py``.

  * the C client groups partition the global batch along its rows; client
    c owns rows [c GB/C, (c + 1) GB/C), and its loss and accuracy come from
    them;
  * ``robust=None``: the trust/team-weighted sum of the clients' grads is
    ONE weighted backward pass (no per-client update ever exists, so no
    kernel runs);
  * ``robust='per_client'``: each client's grads are taken by its own
    backward pass and written straight into the per-leaf views of one
    contiguous fp32 (C, N) buffer, which the Eq.-11 pipeline streams in
    place: ``aggregation.aggregate`` (K1 -> gate -> K2, + K3 for Krum) or,
    with ``FedConfig.compress``, EF + the codec and then
    ``comm_codecs.fused_dequant_aggregate_tree`` from the int8 wire codes
    (K6a -> gate -> K6b, + K6c);
  * fitness, dynamic alpha, the threshold election, adaptive slots and
    trust are O(C) tensors in the state, then an optimizer step
    (``optim/optimizers.py``).

The state may be placed on a (data, model) mesh (``launch/mesh.py``) by
any ``sharding/specs.py`` layout (``place_state``): its params and
optimizer leaves are then DTensors (``sharding/dtensor.py``), the O(C)
federation state plain tensors, the same on every rank.

  * ``robust=None`` on a placed state: the batch is split over the data
    axes and the weighted backward runs on the DTensors, which insert the
    collectives GSPMD inserts (the FSDP legs' all-gathers over "data" and
    the grads' reduce-scatters, TP's partial sums over "model");
  * ZeRO-1 (``zero1_shardings``): the same on a bf16 compute copy in a
    layout whole over "data", the grads reduce-scattered into the master
    layout in fp32;
  * ``robust='per_client'`` with ``agg_mesh`` (W ranks, data x model):
    data index i takes the grads of its C/data clients (the batch's rows
    staged by ``batch_sharding``) on a copy of the params that is TP over
    "model" and whole over "data" (an FSDP leg's reduce-scatter over "data"
    would sum the grads of different clients); each rank keeps its pieces
    of them as the copy holds them over "model".  The dense aggregation
    (``aggregation.aggregate_tp``) shards those columns over "data" by one
    all_to_all, each rank streams only its shard through the kernels, the
    partials are all-reduced, and the result is all-gathered over "data"
    and placed as the params are: no grads cross "model".  With a codec
    (or ``fused_agg=False``, or ``agg_axes``) one all_to_all over "model"
    first joins each rank's C/W clients' rows whole (the codec's blocks lie
    on whole leaves), and ``comm_codecs.fused_dequant_aggregate_sharded``
    / ``aggregation.aggregate_sharded`` run on them; the per-client
    losses and accuracies are all-gathered over the data axes for fitness.

Multi-round training runs through ``run`` on the chunked driver
(``core/driver.py``): on the card the step (autograd, aggregation,
optimizer, collectives) is captured once as a CUDA graph and replayed.  It
is safe to capture: the round index and step count are device tensors no
host branch reads, every constant is a device fill, and the state's
generator (``PodFedState.rng``) is drawn from only where the policy is
random (the election's floor and explore terms when their probabilities
are > 0, a stochastic codec).
"""
from __future__ import annotations

import time
from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.comm import codecs, error_feedback
from repro_torch.comm.kernels import comm_codecs as dq
from repro_torch.core import aggregation, fitness, selection, slots
from repro_torch.core import driver as scan_driver
from repro_torch.models import transformer
from repro_torch.optim import optimizers
from repro_torch.sharding import collectives, dtensor, specs


class PodFedState(NamedTuple):
    team: torch.Tensor            # (C,)
    trust: torch.Tensor           # (C,)
    alpha: torch.Tensor
    slot: slots.SlotState
    h: torch.Tensor
    rng: torch.Generator
    round: torch.Tensor           # 0-d int32, 1-indexed
    cum_selected: torch.Tensor
    ef: Any = None                # (C/W, N) EF residual rows (compress on)


class PodState(NamedTuple):
    params: Any
    opt_state: Any
    fed: PodFedState
    step: torch.Tensor            # 0-d int32


def init_pod_state(params, opt_init, C, fed_cfg, rng, *, mesh=None,
                   shardings=None):
    """``rng``: the state's ``torch.Generator``.  With a compressing codec
    and error feedback the state holds the residual rows of this rank's
    clients (C/W of them with a ``mesh``, in the grads buffer's column
    order).  ``shardings``: a function of the state giving a
    ``NamedSharding`` tree over it (e.g. ``lambda st: specs.named(mesh,
    specs.param_specs(st, mesh=mesh))``): the state comes back placed by
    it (``place_state``)."""
    dev = tree.leaves(params)[0].device
    ef = None
    if fed_cfg.compress != "none" and fed_cfg.error_feedback:
        rows = C // (mesh.size if mesh is not None else 1)
        ef = torch.zeros(rows, sum(p.numel() for p in tree.leaves(params)),
                         device=dev)
    state = PodState(
        params=params,
        opt_state=opt_init(params),
        fed=PodFedState(
            team=torch.ones(C, device=dev),
            trust=torch.full((C,), 0.5, device=dev),
            alpha=torch.tensor(fed_cfg.alpha, dtype=torch.float32,
                               device=dev),
            slot=slots.init_slot_state(dev),
            h=torch.tensor(True, device=dev),
            rng=rng,
            round=torch.ones((), dtype=torch.int32, device=dev),
            cum_selected=torch.zeros(C, device=dev),
            ef=ef),
        step=torch.zeros((), dtype=torch.int32, device=dev))
    if shardings is None:
        return state
    return place_state(state, shardings(state))


def _full(like, value, shape=()):
    return torch.full(shape, value, dtype=torch.float32, device=like.device)


def per_client_metrics(params, cfg, batch, C):
    """Per-client (loss, acc, aux) from one forward; batch tokens (GB, S),
    client c the c-th GB/C rows.  The LM head runs a ``loss_chunk`` of the
    sequence at a time (a tail shorter than a chunk is dropped, as in the
    JAX package)."""
    hidden, _, aux = transformer.forward(
        params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
        image_embeds=batch.get("image_embeds"), collect_logits=False)
    GB, S, _ = hidden.shape
    targets = batch["targets"]
    chunk = min(cfg.loss_chunk or S, S)
    n = S // chunk
    loss_tok = torch.zeros(GB, device=hidden.device)
    acc_tok = torch.zeros(GB, device=hidden.device)
    for i in range(n):
        ll, correct = transformer.token_ce(transformer.lm_head(
            params, cfg, hidden[:, i * chunk:(i + 1) * chunk]),
            targets[:, i * chunk:(i + 1) * chunk])
        loss_tok = loss_tok + ll.sum(1)
        acc_tok = acc_tok + correct.sum(1)
    denom = _full(hidden, float(n * chunk))
    loss_c = loss_tok.reshape(C, GB // C).mean(1) / denom
    acc_c = acc_tok.reshape(C, GB // C).mean(1) / denom
    return loss_c, acc_c, aux


def _rows_of(batch, c, bc):
    """Client c's rows of the batch (leaves with the batch's leading
    dim)."""
    GB = batch["targets"].shape[0]
    return {k: (v[c * bc:(c + 1) * bc] if v is not None and v.dim() >= 1
                and v.shape[0] == GB else v) for k, v in batch.items()}


def _leaf_inputs(params):
    """Detached copies of the params' leaves that require grad, and the
    params tree built on them (autograd's inputs)."""
    req = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    return req, tree.unflatten(params, req)


def place_state(state, shardings):
    """``state`` with its params and optimizer leaves as DTensors placed by
    ``shardings``, a ``NamedSharding`` tree over the whole state (e.g.
    ``specs.named(mesh, specs.param_specs(state, mesh=mesh))``, as the
    JAX CLI places its state); the 0-d counters and the O(C) federation
    state stay plain tensors, the same on every rank."""
    return state._replace(
        params=dtensor.place(state.params, shardings.params),
        opt_state=dtensor.place(state.opt_state, shardings.opt_state))


def _dp_axes(mesh):
    return tuple(a for a in mesh.axis_names if a in dtensor.DP_AXES)


def _batch_dtensor(batch, device_mesh):
    """This rank's rows of the batch (cut over the data axes by
    ``batch_shardings``) as DTensors of the whole batch, split over those
    axes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pl = [Shard(0) if n in dtensor.DP_AXES else Replicate()
          for n in device_mesh.mesh_dim_names]
    return {k: (v if v is None or dtensor.is_dtensor(v) else
                DTensor.from_local(v, device_mesh, pl, run_check=False))
            for k, v in batch.items()}


def make_train_step(model_cfg, fed_cfg, train_cfg, *, robust=None,
                    eval_frac=4, zero1_shardings=None, agg_mesh=None,
                    agg_axes=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: {tokens (GB, S) or embeds (GB, S, d), targets (GB, S),
    [image_embeds (GB, T, d)]}, GB % C == 0.  The state may be placed
    (``place_state``); then, and with ``agg_mesh``, the batch is this
    rank's rows over the data axes (``launch.inputs.batch_shardings``).

    The paths (the module docstring): ``robust=None`` is one weighted
    backward, on DTensors where the state is placed (FSDP x TP; DTensor
    inserts the collectives).  ``zero1_shardings`` = (compute, master)
    ``NamedSharding`` trees over the params: ZeRO-1, the forward and
    backward on a bf16 compute copy in the ``compute`` layout (whole over
    "data"), the grads cast to fp32 and brought to the ``master`` layout,
    the post-update evaluation on the bf16 copy of the new params.
    ``robust='per_client'`` with ``agg_mesh`` (and ``agg_axes``, default
    every axis but "pod"): each data index takes the grads of its C/data
    clients on a copy of the params in the ``param_specs_tp`` layout (TP
    over "model", whole over "data"), and the aggregation runs over the
    mesh (``aggregation.aggregate_tp``; with a codec, ``fused_agg=False``
    or ``agg_axes``, on whole rows).  The JAX package ignores
    ``agg_mesh`` off the per-client path; so does this one."""
    C = fed_cfg.n_clients
    mesh = agg_mesh if robust == "per_client" else None
    W = mesh.size if mesh is not None else 1
    if C % W:
        raise ValueError(f"{C} clients do not split over {W} ranks")
    dp = _dp_axes(mesh) if mesh is not None else ()
    n_dp = specs._axis_size(mesh, dp) if dp else 1
    C_local = C // n_dp               # the clients of this data index
    model_mesh = (mesh.over(tuple(a for a in mesh.axis_names if a not in dp))
                  if mesh is not None else None)
    opt_init, opt_update = optimizers.make_optimizer(train_cfg)
    codec = codecs.make_codec(fed_cfg)
    if codec is not None and robust != "per_client":
        raise ValueError(
            "FedConfig.compress needs robust='per_client': the weighted-"
            "backward path fuses aggregation into the backward pass, so "
            "no per-client update ever crosses a client->server boundary")
    if robust not in (None, "per_client"):
        raise ValueError(robust)
    if zero1_shardings is not None and robust is not None:
        raise ValueError("ZeRO-1 is a path of robust=None")
    if fed_cfg.agg_blk is not None:
        raise NotImplementedError(
            "agg_blk is the TPU kernels' VMEM block size; the CUDA kernels "
            "fix their own tiles")
    fuse = dq.should_fuse(codec, fed_cfg)
    # dense fused aggregation over the whole mesh: on the TP pieces as the
    # ranks hold them (``aggregation.aggregate_tp``); else on whole rows
    tp_agg = codec is None and fed_cfg.fused_agg and agg_axes is None
    layouts = {}                # leaf sizes -> codecs.WireLayout
    tp_sh = {}                  # the per-client compute layout, once
    gather = (lambda v: v) if mesh is None else (
        lambda v: collectives.all_gather_rows(v, mesh.over(dp)))

    def eval_slice(batch, n_clients):
        """Held-out-ish slice: the last 1/eval_frac of each client's
        rows."""
        def cut(x):
            if x is None or x.dim() < 2:
                return x
            bc = x.shape[0] // n_clients
            e = max(1, bc // eval_frac)
            xc = x.reshape(n_clients, bc, *x.shape[1:])[:, -e:]
            return xc.reshape(n_clients * e, *x.shape[1:])

        return {k: cut(v) for k, v in batch.items() if v is not None}

    def compute_copy(params):
        """The params the forward runs on: ZeRO-1's bf16 copy in the
        compute layout; the per-client path's TP copy (``tp_copy``); else
        the params themselves."""
        if zero1_shardings is not None:
            return tree.unflatten(params, [
                dtensor.to_layout(p.to(torch.bfloat16), sh)
                for p, sh in zip(tree.leaves(params), dtensor.sharding_leaves(
                    zero1_shardings[0]))])
        if robust == "per_client":
            return tp_copy(params)
        return params

    def tp_copy(params):
        """The per-client path's compute copy: plain params as they are;
        placed params in the ``param_specs_tp`` layout, whole over the data
        axes, as DTensors on the model axis's sub-mesh (plain tensors where
        that axis is 1 wide)."""
        if not dtensor.is_dtensor(tree.leaves(params)[0]):
            return params
        from torch.distributed.tensor import DTensor
        if not tp_sh:
            tp_sh["t"] = specs.named(mesh, specs.param_specs_tp(params,
                                                                mesh=mesh))
        model = [a for a in mesh.axis_names if a not in dp]
        sub = mesh.device_mesh[model[0]] if specs._axis_size(
            mesh, tuple(model)) > 1 else None
        mi = mesh.axis_names.index(model[0]) if model else None

        def one(p, sh):
            loc = dtensor.to_layout(p, sh)
            if sub is None:
                return loc.to_local()
            return DTensor.from_local(loc.to_local(), sub,
                                      [loc.placements[mi]], run_check=False)

        return tree.unflatten(params, [
            one(p, sh) for p, sh in zip(tree.leaves(params),
                                        dtensor.sharding_leaves(tp_sh["t"]))])

    def client_grads(params, batch):
        """Each of this data index's C/data clients' grads, by its own
        backward pass on the compute copy, written as fp32 rows into two
        buffers: ``split`` (C/data, n), this rank's pieces of the leaves
        the copy splits over "model", and ``whole`` (C/data, n'), the
        leaves whole over "model", each with its columns in leaf order.
        For the dense aggregation over the mesh (``aggregate_tp``) each
        buffer is laid out in the reshard's send order
        (``aggregation.tp_columns``: a ``collectives.SendRows``), so the
        grads are copied once, into the buffer the all_to_all sends, as
        the reference's producer emits the column layout; otherwise each
        is one contiguous (C/data, n) matrix.  Returns them, the copy's
        leaves, which leaves are split, and the (C/data,) losses and
        accuracies."""
        cp = compute_copy(params)
        leaves = tree.leaves(cp)
        loc = [dtensor.local(q) for q in leaves]
        split = [dtensor.model_split(q) is not None for q in leaves]
        dev = _device(params)
        widths = [sum(x.numel() for x, f in zip(loc, split) if f is want)
                  for want in (True, False)]
        send_order = mesh is not None and tp_agg
        if send_order:
            cols = [aggregation.tp_columns(n, mesh) for n in widths]
            bufs = [c.empty(C_local, dev) for c in cols]
        else:
            bufs = [torch.empty(C_local, n, device=dev) for n in widths]
        spans, off = [], [0, 0]           # each leaf's buffer and columns
        for x, f in zip(loc, split):
            b = 0 if f else 1
            spans.append((b, off[b], x.numel()))
            off[b] += x.numel()

        def write(c, g, span):
            b, a, n = span
            if not send_order:
                bufs[b][c, a:a + n].copy_(g)
                return
            for dst, lo, hi in cols[b].views(bufs[b], c, a, n):
                dst.copy_(g[lo:hi].view(dst.shape))

        req, p = _leaf_inputs(cp)
        bc = batch["targets"].shape[0] // C_local
        losses, accs = [], []
        for c in range(C_local):
            with torch.enable_grad(), dtensor.mixing(
                    dtensor.is_dtensor(leaves[0])):
                loss, m = transformer.loss_fn(p, model_cfg,
                                              _rows_of(batch, c, bc))
                grads = torch.autograd.grad(loss, req)
            for span, g, q in zip(spans, grads, leaves):
                # this rank's piece, placed as its leaf (a partial sum over
                # "model" reduced)
                write(c, dtensor.local(dtensor.redistribute(
                    g, q.device_mesh, q.placements)
                    if dtensor.is_dtensor(g) else g).reshape(-1), span)
            del grads           # before the next client's backward
            losses.append(dtensor.plain(loss).detach())
            accs.append(dtensor.plain(m["acc"]).detach())
        return (bufs[0], bufs[1], leaves, split, torch.stack(losses),
                torch.stack(accs))

    def whole_rows(bufs, leaves, split):
        """The whole rows of this rank's C/W clients (the model rank's
        block of its data index's clients), (C/W, N) in leaf order, from
        ``client_grads``' buffers: the split leaves' pieces exchanged over
        "model" by one all_to_all and joined on their split dim.  Where no
        leaf is split the whole buffer's rows, with no copy."""
        sb, wb = bufs
        M = model_mesh.size if model_mesh is not None else 1
        r = C_local // M
        lo = (model_mesh.rank if model_mesh is not None else 0) * r
        if not any(split):
            return wb[lo:lo + r]
        recv = collectives.all_to_all(sb.reshape(M, r, -1), model_mesh)
        cols, off = [], [0, 0]
        for q, f in zip(leaves, split):
            x = dtensor.local(q)
            n = x.numel()
            if f:
                piece = recv[:, :, off[0]:off[0] + n].reshape(M, r, *x.shape)
                cols.append(torch.cat(piece.unbind(0),
                                      1 + dtensor.model_split(q))
                            .reshape(r, -1))
            else:
                cols.append(wb[lo:lo + r, off[1]:off[1] + n])
            off[0 if f else 1] += n
        return torch.cat(cols, 1)

    def from_tp(params, outs, leaves, split):
        """The aggregated rows of ``aggregation.aggregate_tp`` (whole over
        the data axes, this rank's pieces over "model") as a tree placed as
        the params are (the data split a local slice, no communication)."""
        res, off = [], [0, 0]
        for p, q, f in zip(tree.leaves(params), leaves, split):
            b = 0 if f else 1
            x = dtensor.local(q)
            o = outs[b][off[b]:off[b] + x.numel()].view(x.shape).to(p.dtype)
            off[b] += x.numel()
            res.append(dtensor.from_model_piece(o, q, p))
        return tree.unflatten(params, res)

    def aggregate(params, bufs, leaves, split, w, team, rng, ef):
        """The Eq.-11 aggregate of the clients' grads (a tree placed like
        params), the uplink bytes a client (None without a codec) and the
        new EF residual rows."""
        if mesh is not None and tp_agg:
            outs = aggregation.aggregate_tp(*bufs, w, team, fed_cfg, mesh)
            return from_tp(params, outs, leaves, split), None, ef
        buf = whole_rows(bufs, leaves, split)
        enc, new_ef, bytes_up_pc = None, ef, None
        if codec is not None:
            sizes = tuple(p.numel() for p in tree.leaves(params))
            if sizes not in layouts:
                layouts[sizes] = codec.layout(sizes)
            layout = layouts[sizes]
            # client->server boundary: EF inject -> encode; only the wire
            # format reaches the server-side aggregation below
            enc, buf, new_ef = error_feedback.compress(
                codec, buf, layout, ef,
                gen=rng if codec.stochastic else None)
            bytes_up_pc = codecs.wire_bytes_per_client(enc)
        if enc is not None and fuse:
            if mesh is not None:
                grads = dq.fused_dequant_aggregate_sharded(
                    enc, layout, w, team, fed_cfg, mesh, like=params,
                    axes=agg_axes)
            else:
                grads = dq.fused_dequant_aggregate_tree(
                    enc, layout, w, team, fed_cfg, like=params)
        elif mesh is not None and fed_cfg.fused_agg:
            grads = aggregation.aggregate_sharded(
                buf, w, team, fed_cfg, mesh, agg_axes, like=params)
        else:
            if mesh is not None:        # the reference needs every row
                buf = collectives.all_gather_rows(buf, mesh)
            # one leaf: the kernels stream the buffer in place
            out = aggregation.aggregate({"u": buf}, w, team, fed_cfg)["u"]
            grads = tree.map(lambda o, p: o.to(p.dtype),
                             tree.row_views(out, params), params)
        # the whole aggregate, placed as the params are (no communication)
        return dtensor.placed_like(grads, params), bytes_up_pc, new_ef

    def weighted_grads(params, batch, w):
        """One weighted backward: (grads placed as ``params``, loss_c,
        acc_c).  On a placed state or under ZeRO-1 the batch and the
        forward are DTensors."""
        cp = compute_copy(params)
        placed = dtensor.is_dtensor(tree.leaves(cp)[0])
        if placed:
            batch = _batch_dtensor(batch, tree.leaves(cp)[0].device_mesh)
        req, p = _leaf_inputs(cp)
        with torch.enable_grad(), dtensor.mixing(placed):
            loss_c, acc_c, aux = per_client_metrics(p, model_cfg, batch, C)
            total = torch.sum(w * loss_c) + aux
            grads = torch.autograd.grad(total, req)
        if zero1_shardings is not None:
            # the grads in fp32, brought to the master layout
            _, master_sh = zero1_shardings
            grads = [dtensor.to_layout(g.float(), sh) for g, sh in zip(
                grads, dtensor.sharding_leaves(master_sh))]
        grads = [_like(g, q) for g, q in zip(grads, tree.leaves(params))]
        return (tree.unflatten(params, grads), dtensor.plain(loss_c).detach(),
                dtensor.plain(acc_c).detach(), batch)

    def eval_metrics(new_params, batch):
        """LL/LA after the update, on the copy the step computes on."""
        ep = compute_copy(new_params)
        placed = dtensor.is_dtensor(tree.leaves(ep)[0])
        with torch.no_grad(), dtensor.mixing(placed):
            ll_c, la_c, _ = per_client_metrics(
                ep, model_cfg, eval_slice(batch, C_local), C_local)
        return dtensor.plain(ll_c), dtensor.plain(la_c)

    def train_step(state: PodState, batch):
        fed = state.fed
        t = fed.round
        dev = fed.team.device
        bytes_up_pc = None
        new_ef = fed.ef

        # ---- round weights: team * trust * equal-size q --------------------
        w = fed.team * fed.trust
        w = w / torch.clamp(w.sum(), min=1e-12)

        if robust == "per_client":
            *bufs, leaves, split, loss_c, acc_c = client_grads(
                state.params, batch)
            grads, bytes_up_pc, new_ef = aggregate(
                state.params, bufs, leaves, split, w, fed.team, fed.rng,
                fed.ef)
            del bufs            # (C, N) fp32: free it before the optimizer
            loss_c, acc_c = gather(loss_c), gather(acc_c)
        else:
            grads, loss_c, acc_c, batch = weighted_grads(state.params, batch,
                                                         w)

        placed = dtensor.is_dtensor(tree.leaves(state.params)[0])
        with dtensor.mixing(placed):
            if train_cfg.grad_clip:
                grads, gnorm = optimizers.clip_by_global_norm(
                    grads, train_cfg.grad_clip)
            else:
                gnorm = optimizers.global_norm(grads)
            updates, new_opt = opt_update(grads, state.opt_state,
                                          state.params)
            new_params = optimizers.apply_updates(state.params, updates)
        gnorm = dtensor.plain(gnorm)

        # ---- fitness: GL/GA pre-update (have it), LL/LA post-update -------
        ll_c, la_c = eval_metrics(new_params, batch)
        ll_c, la_c = gather(ll_c), gather(la_c)
        # LM "accuracy" for Eq. (1): the bounded (0, 1] proxy exp(-loss)
        # blended with token accuracy
        ga = 0.5 * (torch.exp(-loss_c) + acc_c)
        la = 0.5 * (torch.exp(-ll_c) + la_c)
        th = torch.where(t == 1, torch.zeros(C, device=dev),
                         fitness.theta(loss_c, ga, ll_c, la))
        q = _full(w, 1.0 / C, (C,))             # equal data shards on pod
        alpha = (fitness.dynamic_alpha(q, th) if fed_cfg.dynamic_alpha
                 else _full(w, fed_cfg.alpha))
        scores = fitness.score(q, th, alpha)

        avail = torch.ones(C, device=dev)
        if fed_cfg.participation_floor > 0 or fed_cfg.explore_eps > 0:
            floor_u, explore_u = selection.draw_fedfits(C, fed.rng)
        else:                           # u < 0 never holds: nothing to draw
            floor_u = explore_u = torch.zeros(C, device=dev)
        new_team = selection.fedfits_select(
            scores, fed_cfg.beta, avail, floor_u, explore_u,
            floor_prob=fed_cfg.participation_floor,
            explore_eps=fed_cfg.explore_eps)
        new_team = torch.where(t == 1, avail, new_team)
        team = torch.where(fed.h, new_team, fed.team)

        theta_team = fitness.team_theta(th, team)
        new_slot, h_next = slots.update(fed.slot, theta_team, t, fed_cfg.msl,
                                        fed_cfg.pft, adaptive=True)
        new_trust = aggregation.update_trust(fed.trust, scores, team,
                                             fed_cfg.trust_decay)

        new_state = PodState(
            params=new_params, opt_state=new_opt,
            fed=PodFedState(team=team, trust=new_trust, alpha=alpha,
                            slot=new_slot, h=h_next, rng=fed.rng,
                            round=t + 1, cum_selected=fed.cum_selected + team,
                            ef=new_ef),
            step=state.step + 1)
        metrics = {
            "loss": torch.sum(w * loss_c), "acc": torch.sum(w * acc_c),
            "grad_norm": gnorm, "theta_team": theta_team,
            "team_size": team.sum(), "alpha": alpha,
        }
        if bytes_up_pc is not None:
            # measured uplink bytes this round (encoded wire sizes)
            metrics["comm_bytes_up"] = _full(w, bytes_up_pc * C)
        return new_state, metrics

    return train_step


def _device(params):
    """The device the params' leaves live on."""
    return tree.leaves(params)[0].device


def _like(g, p):
    """A grad placed as its param: redistributed to a DTensor param's
    placements, gathered whole for a plain param."""
    if dtensor.is_dtensor(p):
        return dtensor.redistribute(g, p.device_mesh, p.placements)
    return dtensor.plain(g)


def _host(v):
    return v.detach().cpu().numpy()


def _local(batch, batch_sharding):
    if batch_sharding is None:
        return batch
    return tree.map(lambda v, s: s.local(v), batch, batch_sharding)


def run(state, train_step, batch_fn, n_rounds, *, driver="scan",
        chunk_rounds=8, batch_sharding=None, t0=0, on_chunk=None,
        telemetry=None):
    """Multi-round PodEngine training through the chunked driver
    (``core/driver.py``), the subsystem that drives ``fedfits.run``.

    ``train_step`` is a step from ``make_train_step``; ``batch_fn(step)``
    returns one whole batch dict.  ``batch_sharding`` (e.g.
    ``launch.inputs.batch_shardings``) cuts each rank's rows out of it
    before the step sees it.

    driver="scan" (default): ``chunk_rounds`` steps a chunk with the metric
    history on the device (one host read a chunk), chunk k+1's batches
    staged while chunk k runs; on the card the step is captured once as a
    CUDA graph and replayed.  driver="python": the per-step loop, kept for
    parity: the scan history is bit for bit equal to it on the same device.

    Returns (final_state, history rows keyed by "step").  ``on_chunk(state,
    rows)`` fires after each chunk (logging / checkpoint hook); the python
    driver fires it every step.  ``telemetry`` (``obs.Telemetry``) observes
    the drained rows and the driver's spans."""
    if telemetry is not None:
        telemetry.bind_engine("sync")

    if driver == "python":
        history = []
        for t in range(t0, t0 + n_rounds):
            batch = _local(dict(batch_fn(t)), batch_sharding)
            w0 = telemetry.now_us() if telemetry is not None else 0.0
            c0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            row = {k: _host(v) for k, v in metrics.items()}
            row["wall_ms"] = (time.perf_counter() - c0) * 1e3
            row["step"] = t
            if telemetry is not None:
                telemetry.observe_rows([row], w0, telemetry.now_us() - w0,
                                       measured=True)
            if on_chunk is not None:
                on_chunk(state, [row])
            history.append(row)
        return state, history
    if driver != "scan":
        raise ValueError(f"driver must be 'scan' or 'python', got {driver!r}")

    def body(st, xs):
        _, batch = xs
        return train_step(st, batch)

    return scan_driver.run_chunked(
        body, state, batch_fn, n_rounds, chunk_steps=chunk_rounds, t0=t0,
        batch_sharding=batch_sharding, index_key="step", on_chunk=on_chunk,
        telemetry=telemetry)
