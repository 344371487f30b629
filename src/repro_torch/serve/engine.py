"""Continuous-batching serving engine: paged KV and slotted decode (port
of ``repro/serve/engine.py``).

The **decode step** runs every slot at once, (max_slots, 1) tokens through
the transformer over the paged pools; the **admit step** prefills one
request into a freshly taken page run and samples its first token.  Both
are plain functions that update the pools in place and return a new
``SlotState`` and a small output dict; they read nothing back to the host.
The host loop (``run``) makes one host read of that dict a step (as the
JAX engine's ``jax.device_get``), attributes tokens to requests and admits
from the pending queue while the ``HostLedger`` says a slot and pages are
free.

Paged serving takes stacks of ``attn`` and ``moe`` blocks, as the JAX
engine does.  A MoE layer routes every slot's row, the inactive slots' too,
and they take expert capacity as in the JAX engine; its dispatch reads
nothing to the host, so both steps capture with it.

Cache layout: the pools (``kp``/``vp`` and the int8 ``ks``/``vs``) are
stacked over the transformer's layer units, (n_units, N + 1, page, Hkv,
dh) with the drop page last (``models/attention.py``).  The scheduler
context (page table, lengths, active mask) lives in ``SlotState`` and is
broadcast into the per-call cache view (``_with_ctx``).

Sampling: argmax at temperature 0; else a draw of Gumbel noise from the
state's ``torch.Generator`` and the pure function ``sample`` =
argmax(logits / T + g), which is what ``jax.random.categorical`` computes
from its own Gumbel draw.

``run(requests, continuous=False)`` is the fixed-batch baseline: the same
steps, but admission only into an all-empty fleet.

**The captured steps.**  ``run`` drives the engine's own pools and
``SlotState``, allocated once and reset at each run.  On the card each
step, decode and admission, runs eagerly once as its warm-up on a side
stream and is then captured once as a CUDA graph, the new ``SlotState``
copied into the static one and the output packed into one float64 row
inside the graph, with the sampling generator registered with both
graphs; every later step is one replay and one host read.  The decode
step has a fixed (max_slots, 1) shape.  The admission takes its request
from a static device buffer (the prompt padded to ``prompt_pad``, then
``plen``, ``max_new`` and ``req_id``), filled by one non-blocking copy
from pinned host memory, and uses those scalars only as device tensors
(``clamp_max``, a device page count, ``index_select`` of the last hidden
row), so one graph serves every request; its prefill attends by the
plain einsum, as the JAX engine's does.
``_decode`` and ``_admit`` stay callable on any state for the checks.  On
the CPU both steps run eagerly.

Both steps accumulate the serving slice of the telemetry registry into
``SlotState.tele``, and ``run(telemetry=...)`` emits one measured row a
decode step (the ``serve/*`` values, the admissions since the last step
and the step's host-clock tokens/s).
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch import device as device_mod, tree
from repro_torch.core.driver import copy_into
from repro_torch.kernels import launches
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer
from repro_torch.obs import counters as obs_counters
from repro_torch.serve import scheduler as sched
from repro_torch.serve.scheduler import (HostLedger, Request, ServeConfig,
                                         SlotState)

POOL_KEYS = ("kp", "vp", "ks", "vs")


def init_paged_cache(cfg, scfg: ServeConfig, device=None):
    """Stacked page pools for the layer units (pools only; the scheduler
    context is put in per call by ``_with_ctx``)."""
    cycle, n_units = transformer.layer_cycle(cfg)
    if any(k not in ("attn", "moe") for k in cycle):
        raise ValueError(
            "paged serving supports homogeneous attn/moe stacks, got "
            f"{cycle}")
    one = attn_lib.init_paged_kv_cache(
        cfg, 1, scfg.total_pages, scfg.page_size, 1, int8=scfg.kv_int8,
        dtype=torch.float32, device=device)
    return {f"b{i}": {k: v.expand(n_units, *v.shape).clone()
                      for k, v in one.items() if k in POOL_KEYS}
            for i in range(len(cycle))}


def _with_ctx(pools, table, length, active, new_valid):
    """Cache view for one forward call: the pools plus the scheduler
    context broadcast over the stacked layer units (views, no copy)."""
    ctx = {"table": table, "length": length, "active": active,
           "new_valid": new_valid}
    out = {}
    for name, block in pools.items():
        n_units = block["kp"].shape[0]
        b = dict(block)
        for k, v in ctx.items():
            b[k] = v.expand(n_units, *v.shape)
        out[name] = b
    return out


def _strip_ctx(cache):
    """The pools out of a forward's cache view (the same tensors, written
    in place; the context stays with ``SlotState``)."""
    return {name: {k: v for k, v in block.items() if k in POOL_KEYS}
            for name, block in cache.items()}


def kv_bytes_read(cfg, scfg: ServeConfig, pages_in_use: float) -> float:
    """KV bytes one decode step streams from the pools (all layers): live
    pages x rows x heads x head dim x itemsize x {k, v}, plus the fp32
    scale planes on the int8 path."""
    cycle, n_units = transformer.layer_cycle(cfg)
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    rows = pages_in_use * scfg.page_size
    item = 1 if scfg.kv_int8 else 4
    per_layer = 2.0 * rows * hkv * (dh * item + (4 if scfg.kv_int8 else 0))
    return per_layer * n_units * len(cycle)


def sample(logits, temperature, gumbel=None):
    """Next tokens from (S, V) logits: argmax at temperature 0, else
    argmax(logits / T + gumbel) (a categorical draw given the noise)."""
    if temperature > 0:
        return torch.argmax(logits / temperature + gumbel, -1)
    return torch.argmax(logits, -1)


def _draw(gen, shape, temperature, device):
    """Gumbel noise for ``sample`` (None at temperature 0)."""
    if temperature <= 0:
        return None
    e = torch.empty(shape, device=device).exponential_(generator=gen)
    return -torch.log(e)


def _set_row(x, slot, value):
    """x with row ``slot`` set to ``value``; x unchanged where ``slot`` is
    the drop index x.shape[0] (JAX's ``.at[sl].set(..., mode="drop")``)."""
    hit = torch.arange(x.shape[0], device=x.device) == slot
    hit = hit.reshape(-1, *([1] * (x.dim() - 1)))
    return torch.where(hit, value, x).to(x.dtype)


class ServeEngine:
    """The admit and decode steps over one model and serving config, and
    the host loop.  ``params`` must lie on ``device`` (the card unless
    ``device="cpu"``)."""

    def __init__(self, cfg, scfg: ServeConfig, params, *, seed: int = 0,
                 device=None):
        self.device = device_mod.resolve(device)
        if tree.leaves(params)[0].device.type != self.device.type:
            raise ValueError(f"params are not on {self.device}")
        self.cfg = cfg.replace(
            attn_impl="pallas" if scfg.attn == "pallas" else "xla")
        self.scfg = scfg
        self.params = params
        self.seed = seed
        self._decode = self._make_decode()
        self._admit = self._make_admit()
        self._static = None         # (pools, SlotState) that ``run`` drives
        self._graph = None          # the captured decode step
        self._admit_graph = None    # the captured admission
        # the admission's request, (prompt_pad + 3,) int64: the padded
        # prompt, plen, max_new, req_id; filled from pinned host memory
        n = scfg.prompt_pad + 3
        self._req = torch.zeros(n, dtype=torch.int64, device=self.device)
        self._req_host = torch.zeros(n, dtype=torch.int64,
                                     pin_memory=self.device.type == "cuda")

    # -- state ---------------------------------------------------------
    def fresh_state(self) -> Tuple[dict, SlotState]:
        cache = init_paged_cache(self.cfg, self.scfg, self.device)
        gen = torch.Generator(self.device).manual_seed(self.seed)
        return cache, sched.init_slot_state(self.scfg, gen, self.device)

    # -- decode step ---------------------------------------------------
    def _make_decode(self):
        cfg, scfg = self.cfg, self.scfg
        s, n, maxp = scfg.max_slots, scfg.total_pages, scfg.pages_per_slot

        def decode(params, pools, st: SlotState):
            dev = st.active.device
            view = _with_ctx(pools, st.table, st.length, st.active,
                             torch.zeros((s,), dtype=torch.int32,
                                         device=dev))
            logits, view, _ = transformer.forward(
                params, cfg, tokens=st.tok, positions=st.length[:, None],
                cache=view)
            lg = logits[:, 0]
            g = _draw(st.gen, lg.shape, scfg.temperature, dev)
            nxt = sample(lg, scfg.temperature, g)
            act = st.active
            new_len = st.length + (act > 0).to(torch.int32)
            done = (act > 0) & ((new_len >= st.budget) | (nxt == scfg.eos_id))
            done_f = done.float()
            owned = (torch.arange(maxp, device=dev)[None, :]
                     < st.alloc[:, None]) & done[:, None]
            free = sched.set_masked(st.free, st.table, 1.0, owned)
            new_active = act * (1.0 - done_f)
            zero = torch.zeros((), device=dev)
            vals = {"serve/slot_occupancy": new_active.sum(),
                    "serve/admitted": zero,
                    "serve/evicted": done_f.sum(),
                    "serve/tokens": act.sum(),
                    "serve/pages_in_use": n - free.sum(),
                    "serve/tokens_per_s": zero}
            st2 = st._replace(
                tok=nxt[:, None], length=new_len, active=new_active,
                alloc=torch.where(done, 0, st.alloc), free=free,
                tele=obs_counters.accumulate(st.tele, vals, "serve"))
            out = {"next": nxt, "emitted": act, "finished": done_f,
                   "req": st.req_id, "vals": vals}
            return _strip_ctx(view), st2, out

        return decode

    # -- admit step ----------------------------------------------------
    def _make_admit(self):
        cfg, scfg = self.cfg, self.scfg
        s, n, maxp = scfg.max_slots, scfg.total_pages, scfg.pages_per_slot
        pmax = scfg.prompt_pad

        def admit(params, pools, st: SlotState, prompt, plen, max_new,
                  req_id):
            """prompt: (prompt_pad,) int64 on the device; plen, max_new,
            req_id: 0-d integer tensors on the device (host ints are taken
            too, copied up; the captured admission passes tensors)."""
            dev = st.active.device
            as_dev = lambda v: v if isinstance(v, torch.Tensor) \
                else torch.tensor(v, dtype=torch.int32, device=dev)
            plen, max_new, req_id = map(as_dev, (plen, max_new, req_id))
            plen, max_new = plen.to(torch.int32), max_new.to(torch.int32)
            slot, has_slot = sched.pick_free_slot(st.active)
            budget = torch.clamp_max(plen + max_new - 1, scfg.max_len)
            need = torch.div(budget + scfg.page_size - 1, scfg.page_size,
                             rounding_mode="floor")
            pages, fits, free2 = sched.take_pages(st.free, need, maxp)
            ok = has_slot & fits
            live = ok & (max_new >= 2)
            # a max_new = 1 request completes at admission: its transient
            # pages go straight back (appends overwrite stale rows before
            # any mask exposes them)
            free3 = torch.where(live, free2, st.free)
            row = torch.where(ok, pages, 0)
            i32 = dict(dtype=torch.int32, device=dev)
            view = _with_ctx(pools, row[None], torch.zeros((1,), **i32),
                             torch.ones((1,), device=dev),
                             torch.where(ok, plen, 0).to(torch.int32)[None])
            hidden, view, _ = transformer.forward(
                params, cfg, tokens=prompt[None],
                positions=torch.arange(pmax, device=dev)[None], cache=view,
                collect_logits=False)
            last = hidden[0].index_select(0, (plen - 1).reshape(1).long())
            lg = transformer.lm_head(params, cfg, last[None])[0]
            g = _draw(st.gen, lg.shape, scfg.temperature, dev)
            tok0 = sample(lg, scfg.temperature, g)[0]
            sl = torch.where(ok, slot, s)                    # s = drop row
            live_f = live.float()
            active2 = _set_row(st.active, sl, live_f)
            vals = {"serve/slot_occupancy": active2.sum(),
                    "serve/admitted": ok.float(),
                    "serve/evicted": ok.float() * (1.0 - live_f),
                    "serve/tokens": ok.float(),
                    "serve/pages_in_use": n - free3.sum(),
                    "serve/tokens_per_s": torch.zeros((), device=dev)}
            st2 = st._replace(
                tok=_set_row(st.tok, sl, tok0),
                length=_set_row(st.length, sl, plen),
                budget=_set_row(st.budget, sl, budget),
                active=active2, req_id=_set_row(st.req_id, sl, req_id),
                alloc=_set_row(st.alloc, sl,
                               torch.where(live, need, 0).to(torch.int32)),
                table=_set_row(st.table, sl, row), free=free3,
                tele=obs_counters.accumulate(st.tele, vals, "serve"))
            out = {"ok": ok, "slot": slot, "tok0": tok0, "vals": vals}
            return _strip_ctx(view), st2, out

        return admit

    # -- the engine's own state and its captured steps -----------------
    def _reset(self) -> Tuple[dict, SlotState]:
        """The engine's pools and ``SlotState``, allocated at the first run
        and put back in place to a fresh state's values at every later
        one: zero pools (unit int8 scales), empty slots, a zero counter
        column, the generator reseeded."""
        if self._static is None:
            self._static = self.fresh_state()
            return self._static
        cache, st = self._static
        for block in cache.values():
            for k, v in block.items():
                v.fill_(1.0 if k in ("ks", "vs") else 0.0)
        st.gen.manual_seed(self.seed)
        copy_into(st, sched.init_slot_state(self.scfg, st.gen, self.device))
        return self._static

    def _capture(self, st: SlotState, run):
        """``run() -> (new SlotState, out)``, a step on the engine's own
        state: run eagerly once on a side stream (the warm-up, whose
        result stands), then captured as a CUDA graph with ``st.gen``
        registered.  Returns ((graph, out, packed out, launches a
        replay), the warm-up's packed out)."""
        cur = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            st2, out = run()
            host = _pack(out)           # before the copy: out may read st
            copy_into(st, st2)
            del st2, out
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(st.gen)
        before = launches.snapshot()
        with torch.cuda.graph(graph, stream=stream):
            st2, out = run()
            packed = _pack(out)
            copy_into(st, st2)
        recorded = launches.since(before)
        launches.restore(before)
        cur.wait_stream(stream)
        return (graph, out, packed, recorded), host

    def _run_step(self, name, st: SlotState, run) -> dict:
        """``run()`` on the engine's own state, its output on the host: a
        replay of the graph kept under ``name``, or (the first time on the
        card, when the graph is captured, and always on the CPU) ``run``
        eagerly."""
        captured = getattr(self, name)
        if captured is not None:
            graph, out, packed, recorded = captured
            graph.replay()
            launches.add(recorded)
            return _unpack(out, packed.cpu().tolist())
        if self.device.type != "cuda":
            st2, out = run()
            host = _to_host(out)        # before the copy: out reads st
            copy_into(st, st2)
            return host
        captured, host = self._capture(st, run)
        setattr(self, name, captured)
        return _unpack(captured[1], host.cpu().tolist())

    def _step(self, cache, st: SlotState) -> dict:
        """One decode step on the engine's own state (``_run_step``)."""
        return self._run_step(
            "_graph", st, lambda: self._decode(self.params, cache, st)[1:])

    def _load_request(self, r: Request) -> None:
        """``r`` into the static request buffer: the prompt padded to
        ``prompt_pad``, then plen, max_new and req_id, written on the host
        and sent up by one non-blocking copy from pinned memory (the
        previous admission's host read has finished with it)."""
        h = self._req_host.numpy()
        h[:] = 0
        h[:len(r.tokens)] = r.tokens
        h[-3:] = (len(r.tokens), r.max_new, r.req_id)
        self._req.copy_(self._req_host, non_blocking=True)

    def _admit_static(self, cache, st: SlotState):
        """``_admit`` of the request in the static buffer."""
        p = self.scfg.prompt_pad
        req = self._req
        _, st2, out = self._admit(self.params, cache, st, req[:p], req[p],
                                  req[p + 1], req[p + 2])
        return st2, out

    def _admission(self, cache, st: SlotState, r: Request) -> dict:
        """Admits ``r`` into the engine's own state (``_run_step``); its
        output on the host is the one read an admission, for the
        scheduler's mirror check."""
        self._load_request(r)
        return self._run_step("_admit_graph", st,
                              lambda: self._admit_static(cache, st))

    # -- host loop -----------------------------------------------------
    def run(self, requests: Sequence[Request], *, telemetry=None,
            continuous: bool = True) -> Tuple[Dict[int, List[int]], dict]:
        """Serve ``requests``; returns ({req_id: tokens}, stats).

        continuous=True: admit whenever a slot and pages free up.
        continuous=False: the fixed-batch baseline, admitting only into an
        all-empty fleet (the same steps; scheduling is the only
        difference).  ``telemetry`` (an ``obs.Telemetry``) gets one
        measured row a decode step.  ``stats`` holds the host-clock
        seconds of each decode step (``step_s``) and admission
        (``admit_s``)."""
        scfg = self.scfg
        for r in requests:
            sched.validate_request(r, scfg)
        if telemetry is not None:
            telemetry.bind_engine("serve")
        ledger = HostLedger(scfg)
        pending = list(requests)
        cache, st = self._reset()
        results: Dict[int, List[int]] = {r.req_id: [] for r in requests}
        occupancy_trail: List[int] = []
        step_s: List[float] = []
        admit_s: List[float] = []
        steps = total_emitted = admitted_since = 0
        t0 = time.perf_counter()
        while pending or ledger.n_active > 0:
            group_open = ledger.n_active == 0
            while pending:
                r = pending[0]
                need = sched.pages_needed(len(r.tokens), r.max_new, scfg)
                if not ledger.can_admit(need):
                    break
                if not continuous and not group_open:
                    break
                pending.pop(0)
                want_slot = ledger.next_slot()
                ta = time.perf_counter()
                out = self._admission(cache, st, r)
                admit_s.append(time.perf_counter() - ta)
                if not out["ok"] or out["slot"] != want_slot:
                    raise RuntimeError(
                        f"scheduler mirror diverged on req {r.req_id}: "
                        f"device ok={out['ok']} slot={out['slot']}, host "
                        f"slot={want_slot}")
                results[r.req_id].append(out["tok0"])
                total_emitted += 1
                admitted_since += 1
                if r.max_new >= 2:
                    ledger.admit_at(want_slot, need)
            if ledger.n_active == 0:
                if pending:
                    raise RuntimeError("scheduler stalled with pending "
                                       "requests (pool too small?)")
                break
            w0 = telemetry.now_us() if telemetry is not None else 0.0
            ts = time.perf_counter()
            out = self._step(cache, st)
            dt = time.perf_counter() - ts
            step_s.append(dt)
            steps += 1
            ntok = 0
            for i in range(scfg.max_slots):
                if out["emitted"][i] > 0:
                    results[out["req"][i]].append(out["next"][i])
                    ntok += 1
                if out["finished"][i] > 0:
                    ledger.evict(i)
            total_emitted += ntok
            occupancy_trail.append(int(out["vals"]["serve/slot_occupancy"]))
            if telemetry is not None:
                pre = obs_counters.METRIC_PREFIX
                row = {"round": steps}
                row.update({pre + k: float(v) for k, v in out["vals"].items()})
                row[pre + "serve/admitted"] = float(admitted_since)
                row[pre + "serve/tokens_per_s"] = ntok / max(dt, 1e-9)
                telemetry.observe_rows([row], w0, telemetry.now_us() - w0,
                                       measured=True, phases=False)
            admitted_since = 0
        wall = time.perf_counter() - t0
        stats = {
            "engine": "continuous" if continuous else "fixed",
            "steps": steps,
            "tokens": total_emitted,
            "wall_s": wall,
            "tokens_per_s": total_emitted / max(wall, 1e-9),
            "occupancy_trail": occupancy_trail,
            "step_s": step_s,
            "admit_s": admit_s,
            "free_pages_end": ledger.free_pages,
        }
        return results, stats


def _pack(out):
    """The step's small output dict as one float64 row on its device."""
    return torch.cat([t.reshape(-1).double() for t in tree.leaves(out)])


def _to_host(out):
    """The step's small output dict on the host, in one transfer: tensors
    to Python numbers and lists."""
    return _unpack(out, _pack(out).cpu().tolist())


def _unpack(out, host):
    """``out``'s structure filled from the float64 row ``host``: integer
    tensors to ints, floating ones to floats, lists for vectors."""
    flat = tree.leaves(out)
    vals, i = [], 0
    for t in flat:
        k = t.numel()
        v = [int(x) if not t.is_floating_point() else x
             for x in host[i:i + k]]
        vals.append(v if t.dim() else v[0])
        i += k
    return tree.unflatten(out, vals)
