"""Buffered-async round engine — the port of ``repro/core/async_engine.py``:
population-scale client scheduling with deadline/timeout semantics and
graceful degradation under client failure.

  population   M registered clients live in a ``ClientStore``; each round
               samples a cohort of C = ``fed_cfg.n_clients`` rows by O(M)
               Gumbel-top-d over the store's fitness x trust priority
               (``clientstore.select_cohort`` -> K7 under
               ``select_method="pallas"``) and gathers just those rows.
  deadline     every cohort delivery races ``async_deadline`` with an
               exponential delay (``core/faults.py``); on-time updates
               aggregate at full weight.
  buffer       a late update parks in a DeliveryBuffer of B = C *
               ``async_max_retries`` rows and retries on later rounds with
               capped backoff: a row aged a listens for deadline *
               backoff^a.  When it lands it aggregates at weight n_k *
               trust * staleness_decay^a.
  timeout      a row that exhausts its retries, or finds the buffer full,
               is abandoned: billed, never aggregated, and its client's
               failures rise and trust decays.
  guard        every delivery passes ``aggregation.sanitize_updates``.

Layout: the round works on one persistent (C + B + 1, N) fp32 matrix, the
buffer's ``rows``: the first C rows take this round's ``w_k - w``, the
next B are the parked updates (``DeliveryBuffer.upd``), and the last row
takes the parks that are dropped.  K1-K3 read the first C + B rows in
place, so there is no per-round concatenate; parking is an
``index_copy_`` of fresh rows into free buffer slots.  Parked rows stay as
they arrived: the guard's zeroed copy never reaches the buffer.  The round
updates ``rows`` in place, so the state passed in must not be used again.

Attacks (``core/attacks.py``), as in the JAX round: ``data_attack``
corrupts the cohort's batch and ``update_attack`` its fresh rows (which
then park as attacked), with ``malicious[idx]`` as the cohort's mask.  A
stateful attacker's carry rides ``AsyncState.attacker`` with an (M,) gate
column; the round hands it the cohort's view (``gather``) and closes it
with an (M,) column of this round's gate outcome, a scatter-max over the
owners of the fresh and landed rows (order-independent, so duplicate
owners stay deterministic on CUDA).

Randomness: the round is ``draw(state)``, which takes the cohort's Gumbel
noise, the per-client batch indices, the delay uniforms and a noisy
attack's noise from ``state.rng``, plus a pure ``round_fn(state, draws)``,
so a test can feed the JAX package's own draws.  The round reads nothing
back to the host before its metrics: the park slots, the free count and
every decision stay on the device, so the round, draws included, is safe
to capture as a CUDA graph (``core/driver.py``): its round index is a 0-d
int32 tensor and its constants are made once, in ``make_async_round``.

Telemetry (``obs/``): with ``AsyncState.tele`` set, the round publishes
the registry's async slice (the buffer's counters and its retry-age
histogram among them) into the column and under ``obs/`` history keys, a
pure readout; with ``tele=None`` it is the same program as without it.
Compression raises ``ValueError``, as in the JAX package.
"""
from __future__ import annotations

import time
from typing import Any, NamedTuple

import torch

from repro_torch import device as device_mod, tree
from repro_torch.comm import codecs
from repro_torch.core import aggregation, attacks, clientstore, fairness, \
    faults as faults_mod, fitness
from repro_torch.core import driver as scan_driver
from repro_torch.core.fedfits import _check_supported, _host, \
    make_client_update, observe_round
from repro_torch.kernels import population_select as ps
from repro_torch.obs import counters as obs_counters
from repro_torch.obs.trace import annotate


class DeliveryBuffer(NamedTuple):
    """Fixed-capacity parking lot for late deliveries (B rows)."""
    rows: torch.Tensor        # (C + B + 1, N) fp32: fresh | parked | drop
    owner: torch.Tensor       # (B,) i32 population row of the delivery
    n_k: torch.Tensor         # (B,) f32 owner's example count (weight)
    age: torch.Tensor         # (B,) i32 rounds spent buffered (>= 1)
    remaining: torch.Tensor   # (B,) f32 delay left past consumed windows
    active: torch.Tensor      # (B,) 0/1 occupancy

    @property
    def upd(self) -> torch.Tensor:
        """(B, N) parked update rows, in the round's column order
        (``tree.row_views(upd, params)`` gives the per-leaf views)."""
        b = self.owner.shape[0]
        return self.rows[-b - 1:-1]


class AsyncState(NamedTuple):
    params: Any
    clients: clientstore.ClientStore   # (M,) population columns
    buf: DeliveryBuffer
    rng: torch.Generator
    round: torch.Tensor                # t (1-indexed), 0-d int32
    cost_client_rounds: torch.Tensor
    cost_bytes_up: torch.Tensor
    cost_bytes_down: torch.Tensor
    attacker: Any = None      # a stateful attacker's (M,) carry, or None
    tele: Any = None          # the telemetry column, or None: off

    @property
    def trust(self):
        return self.clients.trust

    @property
    def gate_trust(self):
        return self.clients.gate_trust

    @property
    def cum_selected(self):
        return self.clients.cum_selected


def buffer_capacity(fed_cfg) -> int:
    """B = C * max_retries: every cohort row can be late every round and
    nothing is evicted before its retries run out."""
    return max(fed_cfg.n_clients * fed_cfg.async_max_retries, 1)


def init_buffer(params, fed_cfg, upd=None) -> DeliveryBuffer:
    """An empty buffer; ``upd`` (B, N), if given, fills the parked rows."""
    b = buffer_capacity(fed_cfg)
    dev = tree.leaves(params)[0].device
    n = sum(p.numel() for p in tree.leaves(params))
    rows = torch.zeros(fed_cfg.n_clients + b + 1, n, device=dev)
    if upd is not None:
        rows[-b - 1:-1] = upd
    zeros = lambda dt: torch.zeros(b, dtype=dt, device=dev)
    return DeliveryBuffer(rows=rows, owner=zeros(torch.int32),
                          n_k=zeros(torch.float32), age=zeros(torch.int32),
                          remaining=zeros(torch.float32),
                          active=zeros(torch.float32))


def init_async_state(params, fed_cfg, rng: torch.Generator, *,
                     attacker=None) -> AsyncState:
    """``attacker``: a stateful update attack, whose ``init`` builds the
    (M,) carry."""
    m = fed_cfg.population or fed_cfg.n_clients
    dev = tree.leaves(params)[0].device
    zero = lambda: torch.zeros((), device=dev)
    return AsyncState(
        params=params, clients=clientstore.init_store(m, device=dev),
        buf=init_buffer(params, fed_cfg), rng=rng,
        round=torch.ones((), dtype=torch.int32, device=dev),
        cost_client_rounds=zero(), cost_bytes_up=zero(),
        cost_bytes_down=zero(),
        attacker=None if attacker is None else attacker.init(m, device=dev))


def delivery_weights(n_k, trust, mask, age, *, staleness_decay):
    """The normalised aggregation weights of one async round: n_k * trust *
    staleness_decay^age per masked-in delivery, normalised over the round's
    deliveries.  A convex combination (entries in [0, 1] summing to 1, or
    all zero for an empty round); the round feeds the same raw weights
    through ``aggregation.aggregate``, which normalises identically."""
    sd = torch.full((), staleness_decay, dtype=torch.float32,
                    device=n_k.device)
    w = n_k * trust * sd ** age.float()
    return aggregation.normalize_weights(w, mask)


def make_async_round(model, fed_cfg, pop_data, *, batch_size=32,
                     eval_batch=32, data_attack=None, update_attack=None,
                     malicious=None, faults=None, straggler_rows="tail"):
    """Builds the buffered-async round: returns ``(draw, round_fn)``.

    ``pop_data``: population-stacked {x: (M, cap, ...), y, eval_x, eval_y,
    n} on the device (``Federation.data``).  ``draw(state)`` takes the
    round's draws from ``state.rng``: {gumbel (M,) f32, bi (C, bsz) i64, ei (C,
    esz) i64, u_delay (C,) f32 in [1e-7, 1) when stragglers are active, and
    data_noise / update_noise for an attack that ``draws_noise``};
    ``round_fn(state, draws) -> (state, metrics)`` is a pure function of
    them (it updates the buffer's rows in place).  ``malicious``: (M,) 0/1
    over the population; the attack protocol is ``core/attacks.py``'s.
    """
    if fed_cfg.compress != "none":
        raise ValueError(
            f"compress={fed_cfg.compress!r}: the buffered-async engine is "
            "dense-uplink only; use the sync engine (fedfits.run) for a "
            "compressed uplink, or compress='none' here")
    _check_supported(fed_cfg)
    client_update = make_client_update(model, fed_cfg)
    m = fed_cfg.population or fed_cfg.n_clients
    c = fed_cfg.n_clients
    b = buffer_capacity(fed_cfg)
    retries = int(fed_cfg.async_max_retries)
    decay = fed_cfg.trust_decay
    dev = pop_data["x"].device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    deadline, backoff = f32(fed_cfg.async_deadline), f32(fed_cfg.async_backoff)
    sdecay = f32(fed_cfg.staleness_decay)
    alpha_fixed = f32(fed_cfg.alpha)
    fl = faults if faults is not None else faults_mod.FaultConfig()
    mal = malicious.to(dev) if malicious is not None \
        else torch.zeros(m, device=dev)
    stateful = getattr(update_attack, "stateful", False)
    # per-population-row chronic-straggler delay scales, fixed per run
    scales_pop = faults_mod.delay_scales(fl, m, rows=straggler_rows,
                                         device=dev) \
        if fl.stragglers_active else torch.zeros(m, device=dev)
    cap = pop_data["x"].shape[1]
    ecap = pop_data["eval_x"].shape[1]
    bsz = min(batch_size, cap)
    esz = min(eval_batch, ecap)
    slots = torch.arange(b, device=dev)

    def draw(state: AsyncState):
        gen = state.rng
        out = {"gumbel": ps.draw_gumbel(m, gen),
               "bi": torch.randint(0, cap, (c, bsz), generator=gen,
                                   device=gen.device),
               "ei": torch.randint(0, ecap, (c, esz), generator=gen,
                                   device=gen.device)}
        if fl.stragglers_active:
            out["u_delay"] = faults_mod.draw_delays(c, gen)
        if getattr(data_attack, "draws_noise", False):
            shape = (c, bsz) + tuple(pop_data["x"].shape[2:])
            out["data_noise"] = attacks.draw_noise(shape, gen)
        if getattr(update_attack, "draws_noise", False):
            n = sum(p.numel() for p in tree.leaves(state.params))
            out["update_noise"] = attacks.draw_noise((c, n), gen)
        return out

    def round_fn(state: AsyncState, draws):
        t = state.round
        store, buf = state.clients, state.buf
        params = state.params
        ones_c = torch.ones(c, device=dev)

        # ---- O(M) cohort sampling + O(C) gather ------------------------
        with annotate("selection"):
            idx = clientstore.select_cohort(
                store, c, draws["gumbel"], method=fed_cfg.select_method)
            store = clientstore.record_selection(store, idx)
            il = idx.long()[:, None]
            cdata = {"x": pop_data["x"][il, draws["bi"]],
                     "y": pop_data["y"][il, draws["bi"]],
                     "eval_x": pop_data["eval_x"][il, draws["ei"]],
                     "eval_y": pop_data["eval_y"][il, draws["ei"]],
                     "n": pop_data["n"][idx.long()]}
            cmal = mal[idx.long()]
        if data_attack is not None:
            with annotate("attack"):
                cdata = {**cdata, **data_attack(cdata, cmal,
                                                draws.get("data_noise"))}

        # ---- local training, w_k - w into the fresh rows ---------------
        fresh = buf.rows[:c]
        with annotate("client_update"):
            locals_, (gl, ga, ll, la) = client_update(params, cdata)
            for v, w_k, w in zip(tree.leaves(tree.row_views(fresh, params)),
                                 tree.leaves(locals_), tree.leaves(params)):
                torch.sub(w_k, w, out=v)
        att_carry = state.attacker
        if update_attack is not None:
            # the attacked rows are what aggregates and what parks
            with annotate("attack"):
                noise = draws.get("update_noise")
                if stateful:
                    out, att_carry = update_attack(
                        fresh, cmal, noise,
                        update_attack.gather(state.attacker, idx))
                else:
                    out = update_attack(fresh, cmal, noise)
                fresh.copy_(out)

        # ---- fitness at compute time -----------------------------------
        n_c = cdata["n"].float()
        q = fitness.data_quality(n_c, ones_c)
        th = torch.where(t == 1, torch.zeros(c, device=dev),
                         fitness.theta(gl, ga, ll, la))
        alpha = fitness.dynamic_alpha(q, th, ones_c) if fed_cfg.dynamic_alpha \
            else alpha_fixed
        scores = fitness.score(q, th, alpha)
        store = clientstore.record_fitness(store, idx, scores, decay)

        # ---- the delivery race and buffer maturity ---------------------
        with annotate("delivery"):
            if fl.stragglers_active:
                delay = faults_mod.sample_delays(scales_pop[idx.long()],
                                                 draws["u_delay"])
            else:
                delay = torch.zeros(c, device=dev)
            on_time = (delay <= deadline).float()
            late = 1.0 - on_time
            # a row aged a listens for deadline * backoff^a: due if its
            # residual delay fits, abandoned if not and its retries are
            # spent, else it ages one round (fp32, as in the JAX package)
            window = deadline * backoff ** buf.age.float()
            due = buf.active * (buf.remaining <= window).float()
            exhausted = buf.active * (1.0 - due) \
                * (buf.age >= retries).float()
            still = buf.active * (1.0 - due) * (1.0 - exhausted)

        # ---- staleness-weighted aggregation over fresh + due -----------
        owners = torch.cat([idx, buf.owner])
        owner_safe = torch.clamp(owners.long(), 0, m - 1)
        age_all = torch.cat([torch.zeros(c, dtype=torch.int32, device=dev),
                             buf.age])
        nk_all = torch.cat([n_c, buf.n_k])
        mask_pre = torch.cat([on_time, due])
        w_raw = nk_all * store.trust[owner_safe] * sdecay ** age_all.float()
        all_upd = {"u": buf.rows[:c + b]}
        mask, rejected = mask_pre, torch.zeros_like(mask_pre)
        g_nonfinite = g_norm = None
        if fed_cfg.update_guard:
            with annotate("sanitize"):
                guard = aggregation.sanitize_updates if state.tele is None \
                    else aggregation.sanitize_with_kinds   # + the kinds
                all_upd, mask, rejected, *kinds = guard(
                    all_upd, mask_pre, norm_mult=fed_cfg.guard_norm_mult)
            if kinds:
                g_nonfinite, g_norm = (v.sum() for v in kinds)
        with annotate("aggregate"):
            agg = aggregation.aggregate(all_upd, w_raw, mask, fed_cfg)["u"]
        with annotate("writeback"):
            new_params = tree.map(lambda p, u: p + u.to(p.dtype), params,
                                  tree.row_views(agg, params))

        # ---- cosine gate + trust bookkeeping ---------------------------
        cos = aggregation.cosine_to_ref(all_upd, {"u": agg})
        gated = ((cos < fed_cfg.cosine_outlier_thresh) & (mask > 0)).float()
        bad = torch.maximum(gated, rejected)
        if stateful:
            # the attacker observes its own rows' outcome: an (M,) column,
            # the max over every row a client owns this round
            att_carry = update_attack.observe(
                att_carry, torch.zeros(m, device=dev).scatter_reduce(
                    0, owner_safe, bad * mask_pre, "amax"))
        store = clientstore.record_gate_trust(store, owners, mask_pre, bad,
                                              decay)
        new_tr = decay * store.trust[idx.long()] + (1.0 - decay) * scores
        store = store._replace(trust=store.trust.index_copy(0, idx.long(),
                                                            new_tr))
        store = clientstore.record_deliveries(store, owners,
                                              mask_pre * (1.0 - rejected))

        # ---- buffer update: free landed/abandoned rows, park the late --
        if retries > 0:
            rem_mid = torch.where(still > 0, buf.remaining - window,
                                  torch.zeros_like(window))
            age_mid = torch.where(still > 0, buf.age + 1,
                                  torch.zeros_like(buf.age))
            free = 1.0 - still
            # j-th free slot, in slot order: occupied slots sort last
            slot_order = torch.argsort(torch.where(free > 0, slots,
                                                   b + slots))
            late_rank = (torch.cumsum(late, 0) - 1.0).to(torch.int64)
            can_park = (late > 0) & (late_rank.float() < free.sum())
            dest = torch.where(
                can_park, slot_order[torch.clamp(late_rank, 0, b - 1)],
                torch.full_like(late_rank, b))      # b: the drop slot
            # parked rows are the raw fresh rows (not the guard's copy)
            buf.rows[c:].index_copy_(0, dest, fresh)
            put = lambda col, vals: torch.cat(
                [col, col.new_zeros(1)]).index_put((dest,), vals)[:b]
            new_buf = DeliveryBuffer(
                rows=buf.rows,
                owner=put(buf.owner, idx.to(torch.int32)),
                n_k=put(buf.n_k, n_c),
                age=put(age_mid, torch.ones_like(idx, dtype=torch.int32)),
                remaining=put(rem_mid, delay - deadline),
                active=put(still, ones_c))
            overflow = late * (1.0 - can_park.float())
        else:
            new_buf = buf                           # no retries: no buffer
            overflow = late

        # ---- chronic-failure routing -----------------------------------
        fail = torch.maximum(torch.cat([overflow, exhausted]), rejected)
        store = clientstore.record_failures(store, owners, fail)

        # ---- billing: once per computed round --------------------------
        bytes_up_pc = codecs.dense_bytes_per_client(
            tree.row_views(fresh, params))
        bytes_down_pc = codecs.param_bytes(params)
        team_size = torch.full((), float(c), dtype=torch.float32, device=dev)

        # ---- telemetry readout (obs/): values the round already has -------
        new_tele, obs_metrics = state.tele, {}
        if state.tele is not None:
            zero = torch.zeros((), device=dev)
            wm = w_raw * mask
            vals = {
                "gate/cosine_rejected": gated.sum(),
                "guard/nonfinite": zero if g_nonfinite is None
                else g_nonfinite,
                "guard/norm": zero if g_norm is None else g_norm,
                "select/team_size": team_size,
                "delivery/on_time": on_time.sum(),
                "delivery/late": late.sum(),
                "buffer/occupancy": new_buf.active.sum(),
                "buffer/parked": (late - overflow).sum(),
                "buffer/overflow": overflow.sum(),
                "buffer/exhausted": exhausted.sum(),
                "buffer/age_hist": obs_counters.age_histogram(
                    new_buf.age, new_buf.active, fed_cfg),
                "agg/fresh_mass": wm[:c].sum(),
                "agg/stale_mass": wm[c:].sum(),
                "cohort/trust_q": obs_counters.quantiles(new_tr),
                "cohort/gate_trust_q": obs_counters.quantiles(
                    store.gate_trust[idx.long()]),
                "cohort/fitness_q": obs_counters.quantiles(scores),
                "wire/bytes_up": team_size * bytes_up_pc,
                "wire/bytes_down": team_size * bytes_down_pc,
            }
            new_tele = obs_counters.accumulate(state.tele, vals, "async")
            obs_metrics = obs_counters.metric_keys(vals)
        new_state = AsyncState(
            params=new_params, clients=store, buf=new_buf, rng=state.rng,
            round=t + 1,
            cost_client_rounds=state.cost_client_rounds + c,
            cost_bytes_up=state.cost_bytes_up + c * bytes_up_pc,
            cost_bytes_down=state.cost_bytes_down + c * bytes_down_pc,
            attacker=att_carry, tele=new_tele)
        metrics = {
            "team_size": team_size,
            "cohort": idx, "on_time": on_time, "due": due,
            "exhausted": exhausted,
            "on_time_frac": on_time.mean(),
            "delivered": mask.sum(),
            "buffered": (late - overflow).sum(),
            "buf_fill": new_buf.active.sum(),
            "abandoned": exhausted.sum() + overflow.sum(),
            "guard_rejected": rejected.sum(),
            "gated_frac": gated.sum() / torch.clamp(mask_pre.sum(), min=1.0),
            "gate_trust": store.gate_trust,
            "score": scores, "alpha": alpha,
            "global_loss_mean": gl.mean(), "local_loss_mean": ll.mean(),
            **fairness.round_fairness(ga, ones_c, store.cum_selected),
            **obs_metrics,
        }
        if stateful:
            metrics.update(update_attack.metrics(att_carry))
        return new_state, metrics

    return draw, round_fn


def run_async(model, fed_cfg, pop_data, n_rounds, seed=0, *, eval_fn=None,
              batch_size=32, eval_batch=32, device=None, data_attack=None,
              update_attack=None, malicious=None, faults=None,
              straggler_rows="tail", driver="scan", chunk_rounds=4,
              telemetry=None):
    """Drives ``n_rounds`` buffered-async rounds; returns (state, history).

    ``seed`` seeds the init and the round generator; every round's draws
    come from the latter.  Runs on the card unless ``device="cpu"``.
    ``driver="scan"`` (the default) runs the rounds through the chunked
    driver (``core/driver.py``): on the card the round, its draws and
    ``eval_fn`` are captured once as a CUDA graph and replayed, one host
    read a chunk of ``chunk_rounds``; the batch feed is empty, as in the
    JAX package.  ``driver="python"`` is the per-round loop, bit for bit
    the same history.  Each history row is on the host with ``wall_ms``:
    the round's host time under ``python``, the chunk's host window over
    its rounds under ``scan``.  ``telemetry``: as in ``fedfits.run``, with
    the async counter column."""
    if driver not in ("scan", "python"):
        raise ValueError(f"driver must be 'scan' or 'python', got {driver!r}")
    dev = device_mod.resolve(device)
    pop_data = {k: v.to(dev) for k, v in pop_data.items()}
    draw, round_fn = make_async_round(
        model, fed_cfg, pop_data, batch_size=batch_size,
        eval_batch=eval_batch, data_attack=data_attack,
        update_attack=update_attack, malicious=malicious, faults=faults,
        straggler_rows=straggler_rows)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    state = init_async_state(
        model.init(gen(seed)), fed_cfg, gen(seed + 1),
        attacker=update_attack if getattr(update_attack, "stateful", False)
        else None)
    if telemetry is not None:
        telemetry.bind_engine("async")
        if telemetry.counters:
            state = state._replace(
                tele=obs_counters.init_column("async", fed_cfg, dev))
    if driver == "scan":
        def body(st, xs):
            st, metrics = round_fn(st, draw(st))
            if eval_fn is not None:
                metrics = {**metrics, **eval_fn(st.params)}
            return st, metrics

        return scan_driver.run_chunked(
            body, state, lambda t: {}, n_rounds, chunk_steps=chunk_rounds,
            t0=1, index_key="round", telemetry=telemetry)
    history = []
    for t in range(1, n_rounds + 1):
        w0 = telemetry.now_us() if telemetry is not None else 0.0
        t0 = time.perf_counter()
        state, metrics = round_fn(state, draw(state))
        row = {k: _host(v) for k, v in metrics.items()}
        row["wall_ms"] = (time.perf_counter() - t0) * 1e3
        if eval_fn is not None:
            row.update({k: _host(v) for k, v in eval_fn(state.params).items()})
        row["round"] = t
        observe_round(telemetry, row, w0)
        history.append(row)
    return state, history
