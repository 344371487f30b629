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

With ``agg_mesh`` (``launch/mesh.py``, W ranks) the per-client path is
data parallel: rank r holds the rows of its C/W clients (the batch's rows
staged by ``batch_sharding``), takes their grads, and the aggregation runs
mesh-sharded (``aggregation.aggregate_sharded`` /
``comm_codecs.fused_dequant_aggregate_sharded``): one all_to_all a step
turns the rows into column shards, each rank streams only its shard
through the kernels, the partials are all-reduced and the (N,) aggregate
all-gathered; the per-client losses and accuracies are all-gathered for
fitness.  Params and optimizer state stay whole on every rank.  ZeRO-1
(``zero1_shardings``) is ROADMAP queue 1 item g'.

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


def init_pod_state(params, opt_init, C, fed_cfg, rng, *, mesh=None):
    """``rng``: the state's ``torch.Generator``.  With a compressing codec
    and error feedback the state holds the residual rows of this rank's
    clients (C/W of them with a ``mesh``, in the grads buffer's column
    order)."""
    dev = tree.leaves(params)[0].device
    ef = None
    if fed_cfg.compress != "none" and fed_cfg.error_feedback:
        rows = C // (mesh.size if mesh is not None else 1)
        ef = torch.zeros(rows, sum(p.numel() for p in tree.leaves(params)),
                         device=dev)
    return PodState(
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
        tc = targets[:, i * chunk:(i + 1) * chunk]
        logits = transformer.lm_head(
            params, cfg, hidden[:, i * chunk:(i + 1) * chunk]).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tc[..., None].long())[..., 0]
        correct = (logits.argmax(-1) == tc).float()
        loss_tok = loss_tok + (logz - gold).sum(1)
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


def make_train_step(model_cfg, fed_cfg, train_cfg, *, robust=None,
                    eval_frac=4, zero1_shardings=None, agg_mesh=None,
                    agg_axes=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: {tokens (GB, S) or embeds (GB, S, d), targets (GB, S),
    [image_embeds (GB, T, d)]}, GB % C == 0; with
    ``agg_mesh`` (``robust='per_client'`` only) the rows of this rank's
    C/W clients, (GB/W, S).

    ``agg_mesh`` / ``agg_axes``: shard the robust aggregation's flattened
    param axis over these mesh axes (default: every axis but "pod") via
    ``aggregation.aggregate_sharded`` (module docstring).  The JAX
    package ignores ``agg_mesh`` off the per-client path; so does this
    one, and its batch is then the whole one."""
    if zero1_shardings is not None:
        raise NotImplementedError(
            "ZeRO-1 (bf16 compute copies, reduce-scattered fp32 master "
            "state) is ROADMAP queue 1 item g'")
    C = fed_cfg.n_clients
    mesh = agg_mesh if robust == "per_client" else None
    W = mesh.size if mesh is not None else 1
    if C % W:
        raise ValueError(f"{C} clients do not split over {W} ranks")
    C_local = C // W
    opt_init, opt_update = optimizers.make_optimizer(train_cfg)
    codec = codecs.make_codec(fed_cfg)
    if codec is not None and robust != "per_client":
        raise ValueError(
            "FedConfig.compress needs robust='per_client': the weighted-"
            "backward path fuses aggregation into the backward pass, so "
            "no per-client update ever crosses a client->server boundary")
    if robust not in (None, "per_client"):
        raise ValueError(robust)
    if fed_cfg.agg_blk is not None:
        raise NotImplementedError(
            "agg_blk is the TPU kernels' VMEM block size; the CUDA kernels "
            "fix their own tiles")
    fuse = dq.should_fuse(codec, fed_cfg)
    layouts = {}                # leaf sizes -> codecs.WireLayout
    gather = (lambda v: v) if mesh is None else (
        lambda v: _all_gather(v, mesh))

    def eval_slice(batch):
        """Held-out-ish slice: the last 1/eval_frac of each client's
        rows."""
        def cut(x):
            if x is None or x.dim() < 2:
                return x
            bc = x.shape[0] // C_local
            e = max(1, bc // eval_frac)
            xc = x.reshape(C_local, bc, *x.shape[1:])[:, -e:]
            return xc.reshape(C_local * e, *x.shape[1:])

        return {k: cut(v) for k, v in batch.items() if v is not None}

    def client_grads(params, batch):
        """Each local client's grads, by its own backward pass, written into
        the rows of one contiguous (C/W, N) fp32 buffer; with its (C/W,)
        losses and accuracies."""
        n = sum(p.numel() for p in tree.leaves(params))
        buf = torch.empty(C_local, n, device=tree.leaves(params)[0].device)
        views = tree.leaves(tree.row_views(buf, params))
        req, p = _leaf_inputs(params)
        bc = batch["targets"].shape[0] // C_local
        losses, accs = [], []
        for c in range(C_local):
            with torch.enable_grad():
                loss, m = transformer.loss_fn(p, model_cfg,
                                              _rows_of(batch, c, bc))
                grads = torch.autograd.grad(loss, req)
            for v, g in zip(views, grads):
                v[c].copy_(g)
            del grads           # before the next client's backward
            losses.append(loss.detach())
            accs.append(m["acc"].detach())
        return buf, torch.stack(losses), torch.stack(accs)

    def aggregate(params, buf, w, team, rng, ef):
        """The Eq.-11 aggregate of the clients' grads (a tree like params),
        the uplink bytes a client (None without a codec) and the new EF
        residual rows."""
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
                buf = _all_gather(buf, mesh)
            # one leaf: the kernels stream the buffer in place
            out = aggregation.aggregate({"u": buf}, w, team, fed_cfg)["u"]
            grads = tree.map(lambda o, p: o.to(p.dtype),
                             tree.row_views(out, params), params)
        return grads, bytes_up_pc, new_ef

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
            buf, loss_c, acc_c = client_grads(state.params, batch)
            grads, bytes_up_pc, new_ef = aggregate(state.params, buf, w,
                                                   fed.team, fed.rng, fed.ef)
            del buf             # (C, N) fp32: free it before the optimizer
            loss_c, acc_c = gather(loss_c), gather(acc_c)
        else:
            req, p = _leaf_inputs(state.params)
            with torch.enable_grad():
                loss_c, acc_c, aux = per_client_metrics(p, model_cfg, batch,
                                                        C)
                total = torch.sum(w * loss_c) + aux
                grads = tree.unflatten(state.params,
                                       list(torch.autograd.grad(total, req)))
            loss_c, acc_c = loss_c.detach(), acc_c.detach()

        if train_cfg.grad_clip:
            grads, gnorm = optimizers.clip_by_global_norm(
                grads, train_cfg.grad_clip)
        else:
            gnorm = optimizers.global_norm(grads)

        updates, new_opt = opt_update(grads, state.opt_state, state.params)
        new_params = optimizers.apply_updates(state.params, updates)

        # ---- fitness: GL/GA pre-update (have it), LL/LA post-update -------
        with torch.no_grad():
            ll_c, la_c, _ = per_client_metrics(new_params, model_cfg,
                                               eval_slice(batch), C_local)
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


def _all_gather(v, mesh):
    from repro_torch.sharding import collectives
    return collectives.all_gather_rows(v, mesh)


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
