"""FedFiTS simulation engine — the paper-faithful synchronous round
(Algorithm 1 + 2), port of ``repro/core/fedfits.py``.

Every available client runs E local SGD epochs from the global model
(``torch.func.vmap`` over ``grad``: the client axis is a batch dimension),
then fitness, dynamic alpha, the threshold election, the slot state, the
aggregation-boundary guard and the Eq.-11 aggregation (the fused CUDA
kernels by default), and the trust / gate-trust EWMAs, fairness and
billing.  Only the team is billed (FFA rounds bill every available client).

Update layout: each client's ``w_k - w`` is written straight into per-leaf
views of one (K, N) fp32 buffer, so the aggregation kernels stream one
matrix without a concatenate.

Randomness: ``FedState.rng`` is a ``torch.Generator`` on the device.  The
round draws from it only where the policy is random (the election's floor
and explore terms when their probabilities are > 0, FedRand, FedPow, a
stochastic codec), so with ``participation_floor = explore_eps = 0`` and
``avail_prob = 1`` a round is a deterministic function of (state, batch),
as in JAX.  Faults and noisy attacks draw too, but through ``draws``:
``round_fn(state, data, draws)`` is a pure function of them, and with
``draws=None`` the round takes them from ``state.rng``
(``round_fn.draw``), only for what is active.

Faults (``core/faults.py``), as in the JAX round: stragglers miss the
deadline and drop out of ``avail``; a selected client's update can be lost
mid-round (computed and billed, never aggregated); partial work stops a
client's local SGD after its effective epoch count.  Attacks
(``core/attacks.py``): ``data_attack`` corrupts the batch before local
training, ``update_attack`` the (K, N) update buffer after it and before
the codec; a stateful attacker's carry rides ``FedState.attacker`` and
reads the round's gate outcome (``observe``).

Transport: with ``FedConfig.compress`` the (K, N) update buffer crosses the
client->server boundary encoded (``comm/codecs.py``; EF residuals in the
client store), the guard and a decode-then-aggregate server read its
decode, the int8 path aggregates straight from the codes through the
fused-dequant kernels (``comm/kernels/comm_codecs.py``), and
``cost_bytes_up`` bills the measured wire bytes.

The population-scale engine is ``core/async_engine.py``; this round is its
M == K case whatever ``population`` says, as in the JAX package.

Capture: the round is safe to record as a CUDA graph (``core/driver.py``):
its round index ``FedState.round`` is a 0-d int32 tensor that no host
branch reads, its constants are made by device fills, and every metric is
a tensor.

Telemetry (``obs/``): with ``FedState.tele`` set (``run(telemetry=...)``),
the round also publishes the registry's sync slice, a pure readout of
values it already computes: into the column (``obs.counters.accumulate``)
and under ``obs/`` history keys.  With ``tele=None`` the round is the same
program as without the obs layer.
"""
from __future__ import annotations

import time
from typing import Any, NamedTuple

import torch
from torch.func import grad, vmap

from repro_torch import device as device_mod, tree
from repro_torch.comm import codecs, error_feedback
from repro_torch.comm.kernels import comm_codecs as dq
from repro_torch.core import aggregation, attacks, clientstore, fairness, \
    faults as faults_mod, fitness, selection, slots
from repro_torch.core import driver as scan_driver
from repro_torch.obs import counters as obs_counters
from repro_torch.obs.trace import annotate


class FedState(NamedTuple):
    """Round carry of the synchronous engine; per-client persistent
    columns live in the nested ``clients`` store."""
    params: Any                   # global model w(t-1)
    team: torch.Tensor            # (K,) 0/1 mask S_t
    alpha: torch.Tensor           # current alpha
    slot: slots.SlotState
    h: torch.Tensor               # bool: reselect this round?
    rng: torch.Generator          # draws of the random policies
    round: torch.Tensor           # t (1-indexed), 0-d int32
    cost_client_rounds: torch.Tensor
    cost_bytes_up: torch.Tensor
    cost_bytes_down: torch.Tensor
    clients: clientstore.ClientStore
    attacker: Any = None          # a stateful attacker's carry, or None
    tele: Any = None              # the telemetry column ({name: tensor}),
                                  # or None: telemetry off

    @property
    def trust(self):
        return self.clients.trust

    @property
    def gate_trust(self):
        return self.clients.gate_trust

    @property
    def cum_selected(self):
        return self.clients.cum_selected

    @property
    def ef(self):
        """Per-leaf (K, ...) views of the EF residual buffer, or None."""
        if self.clients.ef is None:
            return None
        return tree.row_views(self.clients.ef, self.params)


def init_state(params, n_clients, fed_cfg, rng: torch.Generator, *,
               attacker=None):
    """``attacker``: a stateful update attack, whose ``init`` builds the
    carry."""
    dev = tree.leaves(params)[0].device
    zero = lambda: torch.zeros((), device=dev)
    return FedState(
        params=params,
        team=torch.ones(n_clients, device=dev),
        alpha=torch.tensor(fed_cfg.alpha, dtype=torch.float32, device=dev),
        slot=slots.init_slot_state(dev),
        h=torch.tensor(True, device=dev),
        rng=rng,
        round=torch.ones((), dtype=torch.int32, device=dev),
        cost_client_rounds=zero(),
        cost_bytes_up=zero(),
        cost_bytes_down=zero(),
        clients=clientstore.init_store(n_clients, params=params,
                                       fed_cfg=fed_cfg, device=dev),
        attacker=None if attacker is None else attacker.init(n_clients,
                                                             device=dev),
    )


def make_client_update(model, fed_cfg):
    """Algorithm 2 for all clients at once: E local SGD epochs from w(t-1)
    on each client's batch; returns the (K, ...) local params and
    (GL, GA, LL, LA), each (K,), on the clients' eval splits.

    ``n_epochs`` (K,) int, if given, is each client's effective epoch
    count (partial work, ``core/faults.py``): epochs past it still compute
    their gradient but leave the params as they are, ``where(i < n_epochs,
    w - lr g, w)`` as in the JAX round."""

    def loss_fn(p, x, y, p0):
        loss, _ = model.loss(p, {"x": x, "y": y})
        if fed_cfg.prox_mu:
            prox = sum(torch.sum(torch.square(a - b)) for a, b in
                       zip(tree.leaves(p), tree.leaves(p0)))
            loss = loss + 0.5 * fed_cfg.prox_mu * prox
        return loss

    def eval_fn(p, x, y):
        loss, m = model.loss(p, {"x": x, "y": y})
        return loss, m["acc"]

    client_grad = vmap(grad(loss_fn), in_dims=(0, 0, 0, None))
    eval_global = vmap(eval_fn, in_dims=(None, 0, 0))
    eval_local = vmap(eval_fn, in_dims=(0, 0, 0))

    def client_update(params, data, n_epochs=None):
        k = data["x"].shape[0]
        local = tree.map(lambda w: w.expand(k, *w.shape), params)
        for i in range(fed_cfg.local_epochs):
            g = client_grad(local, data["x"], data["y"], params)
            if n_epochs is None:
                local = tree.map(lambda w, gw: w - fed_cfg.local_lr * gw,
                                 local, g)
            else:
                on = i < n_epochs
                local = tree.map(
                    lambda w, gw: torch.where(
                        on.reshape((k,) + (1,) * (w.dim() - 1)),
                        w - fed_cfg.local_lr * gw, w), local, g)
        gl, ga = eval_global(params, data["eval_x"], data["eval_y"])
        ll, la = eval_local(local, data["eval_x"], data["eval_y"])
        return local, (gl, ga, ll, la)

    return client_update


def _check_supported(fed_cfg):
    if fed_cfg.agg_blk is not None:
        raise NotImplementedError(
            "agg_blk is the TPU kernels' VMEM block size; the CUDA kernels "
            "fix their own tiles")
    if fed_cfg.algorithm not in ("fedfits", "fedavg", "fedrand", "fedpow"):
        raise ValueError(fed_cfg.algorithm)


def make_round(model, fed_cfg, *, data_attack=None, update_attack=None,
               malicious=None, faults=None):
    """Builds the one-round function ``round_fn(state, data, draws=None) ->
    (state, metrics)``.  data: client-stacked {x: (K, B, ...), y: (K, B),
    eval_x, eval_y, n: (K,)} plus optional {avail: (K,)}, on the state's
    device.

    ``data_attack(batch, malicious, noise)`` / ``update_attack(updates,
    malicious, noise)``: the attack protocol of ``core/attacks.py``;
    ``malicious`` (K,) 0/1 (default: nobody).  ``faults``: a
    ``faults.FaultConfig``.  ``draws``: {u_arrive (K,) when stragglers are
    active, epoch_frac (K,) with partial work, data_noise / update_noise
    for an attack that ``draws_noise``, u_drop (K,) with dropout}; with
    None the round takes them from ``state.rng`` by ``round_fn.draw(state,
    data)``, in that order, and only what is active."""
    _check_supported(fed_cfg)
    client_update = make_client_update(model, fed_cfg)
    K = fed_cfg.n_clients
    fl = faults if faults is not None and faults.active else None
    stateful = getattr(update_attack, "stateful", False)
    E = fed_cfg.local_epochs
    decay = fed_cfg.trust_decay
    codec = codecs.make_codec(fed_cfg)
    fuse = dq.should_fuse(codec, fed_cfg)
    layouts = {}                # leaf sizes -> codecs.WireLayout

    def select(state, scores, gl, avail, n, t):
        rng = state.rng
        if fed_cfg.algorithm == "fedfits":
            if fed_cfg.participation_floor > 0 or fed_cfg.explore_eps > 0:
                floor_u, explore_u = selection.draw_fedfits(K, rng)
            else:                       # u < 0 never holds: nothing to draw
                floor_u = explore_u = torch.zeros_like(scores)
            new_team = selection.fedfits_select(
                scores, fed_cfg.beta, avail, floor_u, explore_u,
                floor_prob=fed_cfg.participation_floor,
                explore_eps=fed_cfg.explore_eps)
            new_team = torch.where(t == 1, avail, new_team)
            return torch.where(state.h, new_team, state.team * avail)
        if fed_cfg.algorithm == "fedavg":
            return selection.fedavg_select(avail)
        if fed_cfg.algorithm == "fedrand":
            return selection.fedrand_select(
                avail, fed_cfg.fedrand_c, selection.draw_fedrand(K, rng))
        d = fed_cfg.fedpow_d or K
        m = fed_cfg.fedpow_m or max(K // 2, 1)
        return selection.fedpow_select(gl, avail, d, m,
                                       selection.draw_fedpow(K, rng), n=n)

    def draw(state: FedState, data):
        """The round's fault and attack draws from ``state.rng``: only for
        what is active, so a round without faults or noisy attacks draws
        nothing here."""
        gen, out = state.rng, {}
        if fl is not None and fl.stragglers_active:
            out["u_arrive"] = faults_mod.draw_arrivals(K, gen)
        if fl is not None and fl.partial_active:
            out["epoch_frac"] = faults_mod.draw_epochs(fl, K, gen)
        if getattr(data_attack, "draws_noise", False):
            out["data_noise"] = attacks.draw_noise(data["x"].shape, gen)
        if getattr(update_attack, "draws_noise", False):
            n = sum(p.numel() for p in tree.leaves(state.params))
            out["update_noise"] = attacks.draw_noise((K, n), gen)
        if fl is not None and fl.dropout_active:
            out["u_drop"] = faults_mod.draw_dropout(K, gen)
        return out

    def round_fn(state: FedState, data, draws=None):
        t = state.round
        params = state.params
        dev = state.team.device
        if draws is None:
            draws = draw(state, data)
        mal = malicious if malicious is not None \
            else torch.zeros(K, device=dev)
        avail = data.get("avail")
        if avail is None:
            avail = torch.ones(K, device=dev)

        # ---- fault injection: stragglers miss the round deadline --------
        # a late client never arrives: it composes with the availability
        # path (selection, fitness masks, the stale catch-up)
        if fl is not None and fl.stragglers_active:
            avail = avail * faults_mod.sample_arrivals(fl, draws["u_arrive"])
        if data_attack is not None:
            with annotate("attack"):
                data = {**data, **data_attack(data, mal,
                                              draws.get("data_noise"))}

        # ---- local training, updates written into one (K, N) buffer ----
        eff_epochs = None
        if fl is not None and fl.partial_active:
            eff_epochs = faults_mod.sample_epochs(draws["epoch_frac"], E)
        with annotate("client_update"):
            locals_, (gl, ga, ll, la) = client_update(params, data,
                                                      eff_epochs)
            n_params = sum(p.numel() for p in tree.leaves(params))
            flat = torch.empty(K, n_params, device=dev)
            views = tree.row_views(flat, params)
            for v, w_k, w in zip(tree.leaves(views), tree.leaves(locals_),
                                 tree.leaves(params)):
                torch.sub(w_k, w, out=v)

        # ---- the attacker corrupts its own update, before the codec ------
        att_carry = state.attacker
        if update_attack is not None:
            with annotate("attack"):
                noise = draws.get("update_noise")
                if stateful:
                    flat, att_carry = update_attack(flat, mal, noise,
                                                    state.attacker)
                else:
                    flat = update_attack(flat, mal, noise)

        # ---- client->server transport: EF inject, encode, decode --------
        # the codec runs client-side; the guard and a decode-then-aggregate
        # server read the decode, the fused-dequant server the wire codes
        enc, new_ef = None, state.clients.ef
        if codec is not None:
            sizes = tuple(p.numel() for p in tree.leaves(params))
            if sizes not in layouts:
                layouts[sizes] = codec.layout(sizes)
            layout = layouts[sizes]
            with annotate("transport"):
                enc, flat, new_ef = error_feedback.compress(
                    codec, flat, layout, state.clients.ef,
                    gen=state.rng if codec.stochastic else None)
            bytes_up_pc = codecs.wire_bytes_per_client(enc)
        else:
            bytes_up_pc = codecs.dense_bytes_per_client(views)
        bytes_down_pc = codecs.param_bytes(params)

        # ---- fitness ----------------------------------------------------
        q = fitness.data_quality(data["n"], avail)
        th = torch.where(t == 1, torch.zeros(K, device=dev),
                         fitness.theta(gl, ga, ll, la))
        if fed_cfg.dynamic_alpha:
            alpha = fitness.dynamic_alpha(q, th, avail)
        else:
            alpha = torch.full((), fed_cfg.alpha, dtype=torch.float32,
                               device=dev)
        scores = fitness.score(q, th, alpha)
        if fed_cfg.trust_in_fitness:
            scores = scores * state.gate_trust

        # ---- selection ----------------------------------------------------
        with annotate("selection"):
            team = select(state, scores, gl, avail, data["n"], t)

        # ---- fault injection: mid-round dropout ---------------------------
        # a selected client computes and is billed, but its update is lost
        # in flight; it is not a stale catch-up contributor
        if fl is not None and fl.dropout_active:
            lost = faults_mod.sample_dropout(fl, draws["u_drop"], team)
        else:
            lost = torch.zeros(K, device=dev)
        delivered = team * (1.0 - lost)

        # ---- aggregation boundary: stale catch-up, then the guard --------
        stale = fed_cfg.stale_weight * state.team * (1.0 - avail)
        part = torch.clamp(delivered + stale, 0.0, 1.0)
        part_pre, stale_pre = part, stale
        rejected = torch.zeros(K, device=dev)
        g_nonfinite = g_norm = None
        if fed_cfg.update_guard:
            with annotate("sanitize"):
                guard = aggregation.sanitize_updates if state.tele is None \
                    else aggregation.sanitize_with_kinds   # + the kinds
                clean, _, rejected, *kinds = guard(
                    {"u": flat}, (part > 0).float(),
                    norm_mult=fed_cfg.guard_norm_mult)
            if kinds:
                g_nonfinite, g_norm = (v.sum() for v in kinds)
            flat = clean["u"]
            delivered = delivered * (1.0 - rejected)
            stale = stale * (1.0 - rejected)
            part = torch.clamp(delivered + stale, 0.0, 1.0)

        n_k = data["n"].float()
        with annotate("aggregate"):
            if fed_cfg.paper_exact_agg:
                w = n_k * delivered
                agg_flat = (w / torch.clamp(w.sum(), min=1e-12)) @ flat
            else:
                weights = n_k * state.trust * (delivered + stale)
                part_mask = (part > 0).float()
                if fuse:
                    agg_flat = dq.fused_dequant_aggregate_tree(
                        enc, layout, weights, part_mask, fed_cfg,
                        like={"u": flat[0]})["u"]
                else:
                    agg_flat = aggregation.aggregate(
                        {"u": flat}, weights, part_mask, fed_cfg)["u"]
        with annotate("writeback"):
            new_params = tree.map(lambda p, u: p + u.to(p.dtype), params,
                                  tree.row_views(agg_flat, params))

        # ---- slot & trust state ------------------------------------------
        theta_team = fitness.team_theta(th, team)
        new_slot, h_next = slots.update(state.slot, theta_team, t,
                                        fed_cfg.msl, fed_cfg.pft)
        new_trust = aggregation.update_trust(state.trust, scores, team,
                                             decay)
        cos = aggregation.cosine_to_ref({"u": flat}, {"u": agg_flat})
        gated = ((cos < fed_cfg.cosine_outlier_thresh) & (part > 0)).float()
        bad = torch.maximum(gated, rejected)
        new_gate_trust = torch.where(
            part_pre > 0,
            decay * state.gate_trust + (1.0 - decay) * (1.0 - bad),
            state.gate_trust)
        if stateful:                    # the attacker reads this next round
            att_carry = update_attack.observe(att_carry, bad)

        # billing: FFA rounds bill every available client, slot rounds the
        # team, plus the stale catch-up contributors in both
        billed = torch.where(state.h, avail.sum(), team.sum())
        if not fed_cfg.paper_exact_agg:
            billed = billed + (stale_pre > 0).sum()

        # ---- telemetry readout (obs/): values the round already has -------
        new_tele, obs_metrics = state.tele, {}
        if state.tele is not None:
            zero = torch.zeros((), device=dev)
            wts = n_k * state.trust
            vals = {
                "gate/cosine_rejected": gated.sum(),
                "guard/nonfinite": zero if g_nonfinite is None
                else g_nonfinite,
                "guard/norm": zero if g_norm is None else g_norm,
                "select/team_size": team.sum(),
                "select/available": avail.sum(),
                "agg/fresh_mass": (wts * delivered).sum(),
                "agg/stale_mass": (wts * stale).sum(),
                "cohort/trust_q": obs_counters.quantiles(new_trust),
                "cohort/gate_trust_q": obs_counters.quantiles(new_gate_trust),
                "cohort/fitness_q": obs_counters.quantiles(scores),
                "wire/bytes_up": billed * bytes_up_pc,
                "wire/bytes_down": billed * bytes_down_pc,
                "fault/lost": lost.sum(),
            }
            new_tele = obs_counters.accumulate(state.tele, vals, "sync")
            obs_metrics = obs_counters.metric_keys(vals)

        cs = state.clients
        new_clients = cs._replace(
            fitness=decay * cs.fitness + (1.0 - decay) * scores,
            trust=new_trust,
            gate_trust=new_gate_trust,
            staleness=torch.where(part > 0, torch.zeros_like(cs.staleness),
                                  cs.staleness + 1),
            failures=cs.failures + rejected,
            cum_selected=cs.cum_selected + team,
            ef=new_ef)
        new_state = FedState(
            params=new_params, team=team, alpha=alpha, slot=new_slot,
            h=h_next, rng=state.rng, round=t + 1,
            cost_client_rounds=state.cost_client_rounds + billed,
            cost_bytes_up=state.cost_bytes_up + billed * bytes_up_pc,
            cost_bytes_down=state.cost_bytes_down + billed * bytes_down_pc,
            clients=new_clients, attacker=att_carry, tele=new_tele)
        n_avail = torch.clamp(avail.sum(), min=1.0)
        metrics = {
            "theta": th, "score": scores, "team": team, "alpha": alpha,
            "theta_team": theta_team, "h_next": h_next,
            "global_loss_mean": (gl * avail).sum() / n_avail,
            "local_loss_mean": (ll * avail).sum() / n_avail,
            "team_size": team.sum(),
            "gate_trust": new_gate_trust,
            "gated_frac": gated.sum() / torch.clamp(part.sum(), min=1.0),
            "guard_rejected": rejected.sum(),
            "fault_lost": lost.sum(),
            "fault_eff_epochs": torch.full((), float(E), device=dev)
            if eff_epochs is None else eff_epochs.float().mean(),
            # per-client masks behind the sums above (not in the JAX round)
            "avail": avail, "lost": lost, "gated": gated,
            "eff_epochs": torch.full((K,), E, device=dev)
            if eff_epochs is None else eff_epochs,
            **fairness.round_fairness(ga, avail, cs.cum_selected + team),
            **obs_metrics,
        }
        if stateful:
            metrics.update(update_attack.metrics(att_carry))
        return new_state, metrics

    round_fn.draw = draw
    return round_fn


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def _draw_avail(k, prob, generator):
    """Round t's availability draw: (K,) 0/1, client 0 always on (never an
    empty round).  Both drivers draw it every round, round 1 included,
    which then runs with everyone available."""
    a = (torch.rand(k, generator=generator, device=generator.device)
         < prob).float()
    a[:1].fill_(1.0)              # a fill on the device: no host copy
    return a


def run(model, fed_cfg, data_fn, n_rounds, seed=0, *, eval_fn=None,
        device=None, data_attack=None, update_attack=None, malicious=None,
        faults=None, driver="scan", chunk_rounds=8, telemetry=None):
    """Drives n_rounds of FL; returns (final_state, history).

    data_fn(round, generator) -> client-stacked batch on the device;
    eval_fn(params) -> dict of server-side metrics (optional, per round).
    ``seed`` seeds the init, round, data and availability generators.
    Runs on the card unless ``device="cpu"``.

    ``driver="scan"`` (the default) runs the rounds through the chunked
    driver (``core/driver.py``): on the card the round is captured once
    as a CUDA graph and replayed, with the history on the device and one
    host read a chunk of ``chunk_rounds``; the availability draw and
    ``eval_fn`` run inside the step, as in the JAX package's scan body.
    ``driver="python"`` is the per-round loop, kept for parity: the same
    draws in the same order, so the two histories are bit for bit equal.
    Each history row is on the host, with ``wall_ms``: under ``python``
    the host time from the round call until its metrics reached the host,
    under ``scan`` the chunk's host window over its rounds (and
    ``chunk_ms``).

    ``telemetry`` (an ``obs.Telemetry``): with ``counters`` on, the state
    carries the sync counter column and every row its ``obs/`` keys; the
    drained rows go to its sinks and monitors, and to its trace (measured
    chunk spans and attributed phases under ``scan``, a measured round
    span each under ``python``)."""
    dev = device_mod.resolve(device)
    if malicious is not None:
        malicious = malicious.to(dev)
    round_fn = make_round(model, fed_cfg, data_attack=data_attack,
                          update_attack=update_attack, malicious=malicious,
                          faults=faults)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    K = fed_cfg.n_clients
    params = model.init(gen(seed))
    state = init_state(params, K, fed_cfg, gen(seed + 1),
                       attacker=update_attack
                       if getattr(update_attack, "stateful", False)
                       else None)
    if telemetry is not None:
        telemetry.bind_engine("sync")
        if telemetry.counters:
            state = state._replace(
                tele=obs_counters.init_column("sync", fed_cfg, dev))
    g_data, g_avail = gen(seed + 2), gen(seed + 3)
    if driver == "scan":
        def body(st, xs):
            t, batch = xs
            batch = dict(batch)
            if fed_cfg.avail_prob < 1.0:
                batch["avail"] = torch.where(
                    t > 1, _draw_avail(K, fed_cfg.avail_prob, g_avail),
                    torch.ones(K, device=dev))
            st, metrics = round_fn(st, batch)
            if eval_fn is not None:
                metrics = {**metrics, **eval_fn(st.params)}
            return st, metrics

        return scan_driver.run_chunked(
            body, state, lambda t: data_fn(t, g_data), n_rounds,
            chunk_steps=chunk_rounds, t0=1, index_key="round",
            generators=(g_avail,), telemetry=telemetry)
    if driver != "python":
        raise ValueError(f"driver must be 'scan' or 'python', got {driver!r}")
    history = []
    for t in range(1, n_rounds + 1):
        batch = dict(data_fn(t, g_data))
        if fed_cfg.avail_prob < 1.0:
            a = _draw_avail(K, fed_cfg.avail_prob, g_avail)
            batch["avail"] = a if t > 1 else torch.ones(K, device=dev)
        w0 = telemetry.now_us() if telemetry is not None else 0.0
        t0 = time.perf_counter()
        state, metrics = round_fn(state, batch)
        row = {k: _host(v) for k, v in metrics.items()}
        row["wall_ms"] = (time.perf_counter() - t0) * 1e3
        if eval_fn is not None:
            row.update({k: _host(v) for k, v in eval_fn(state.params).items()})
        row["round"] = t
        observe_round(telemetry, row, w0)
        history.append(row)
    return state, history


def observe_round(telemetry, row, w0):
    """A per-round loop's row to ``telemetry``: its host read ended the
    round, so the window from ``w0`` is a real measurement of it."""
    if telemetry is not None:
        telemetry.observe_rows([row], w0, telemetry.now_us() - w0,
                               measured=True)
