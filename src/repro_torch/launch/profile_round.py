"""Where a round's time goes: a full-width paper-cnn round on the card,
timed on the host clock and traced by ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_round \
        [--engine sync|async] [--aggregator A] [--compress C]
        [--scenario NAME] [--driver scan|python]

``--engine sync`` (the default) runs the FedFiTS round of
``chip_smoke.py``'s main path (16 clients, batch 32, 2 local epochs), with
the uplink codec ``--compress`` (none, int8, int4, signsgd, topk, randk;
error feedback on).  ``--engine async`` runs the buffered-async round of
``chip_smoke.py``'s phase 5: a cohort of 16 of M=16,384 registered clients
drawn by K7, a retry buffer of 32 rows, chronic stragglers.
``--scenario NAME`` runs one round of a registry cell instead, as
``chip_smoke.py``'s phase 6b runs it (paper-cnn, 16 clients, the cell's
own engine, aggregator, codec, attack and faults).

``--driver python`` (the default here) calls the round once a step from
Python.  ``--driver scan`` runs it through the chunked driver
(``core/driver.py``): 2 warm-up rounds (the first eager, then the capture
of the round as a CUDA graph), and each timed round is then one chunk of
one step, a replay and its one host read; a chunk of 10 rounds is also
timed, for the driver's wall a round over a chunk.

Prints the median round wall time over 10 steady-state rounds (host
clock, each ending in a synchronize), then traces one more round and
prints: device busy time (the union of the kernels' and copies'
intervals, and their sum) and the idle share of the traced wall time,
the host's launches in the round (kernel, copy and memset launches and
graph launches, as the CUDA runtime calls in the trace), the device
time under the port's own CUDA kernels (K1-K3, K6a-c and K7 apart) and
the kernels that take the most device time.
Under ``python`` it also prints the device time under each phase span of
the round (attack, client_update, transport, selection, delivery,
sanitize, aggregate, writeback); a replay runs no Python, so under
``scan`` there are no spans and the kernels are read by name.  Runs on
the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import device as device_mod
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import CNN_CONFIG
from repro_torch.core import async_engine, fedfits
from repro_torch.core.driver import ScanDriver
from repro_torch.core.faults import FaultConfig
from repro_torch.data.pipeline import build_federation
from repro_torch.models.model import build
from repro_torch.obs import counters as obs_counters
from repro_torch.scenarios import engine as scenario_engine, registry

ROUNDS = 10                 # timed steady-state rounds, after 2 warm-up
ASYNC_M, ASYNC_N = 16_384, 131_072   # the async engine's population, data
SPANS = ("attack", "client_update", "transport", "selection", "delivery",
         "sanitize", "aggregate", "writeback")
# the port's own kernels launch through ctypes, outside any torch op, so the
# profiler does not attribute them to a span: they are summed by name.  K1-K3
# and K6a-c are the same templated kernels (pass1_ranks / pass1_partials,
# combine_*, gram_partials) over two row sources; reduce_partials serves
# both.  Pass 1's body (K1 or K6a, without its reduce) is also summed
# apart.  K7 (block_topd_kernel, the cohort's top-d with its merge in one
# launch) launches inside the selection span and is likewise summed by name.
OWN_KERNELS = {"K1-K3": ("DenseRows",), "K6a-c": ("QuantRows",),
               "reduce_partials": ("reduce_partials",),
               "pass 1 (K1/K6a)": ("pass1_",), "K7": ("block_topd",)}
# the CUDA runtime calls that put work on a stream, as the trace names them
HOST_LAUNCHES = ("LaunchKernel", "GraphLaunch", "MemcpyAsync",
                 "MemsetAsync")
COMPRESS = ("none", "int8", "int4", "signsgd", "topk", "randk")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def busy_ms(events):
    """Device busy time of a trace's device events: the union of their
    intervals, in ms.  Kernels and copies of a replayed graph, or of two
    streams, may overlap, so their sum can exceed the wall."""
    total, start, end = 0.0, None, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if end is None or s > end:
            total += 0.0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    return (total + (0.0 if end is None else end - start)) / 1e3


def sync_round(args, dev, gen, fed=None, telemetry=False):
    """The sync engine's round as (body, state, batch_fn, generators); with
    ``telemetry`` the state carries the sync counter column."""
    model = build(CNN_CONFIG)
    if fed is None:
        fed, _ = build_federation(0, kind="images", n=4000, n_clients=16,
                                  batch_size=32, device=dev)
    cfg = FedConfig(n_clients=16, algorithm="fedfits", local_epochs=2,
                    local_lr=0.05, msl=4, pft=2, aggregator=args.aggregator,
                    compress=args.compress, error_feedback=True)
    state = fedfits.init_state(model.init(gen(0)), 16, cfg, gen(1))
    if telemetry:
        state = state._replace(
            tele=obs_counters.init_column("sync", cfg, dev))
    round_fn = fedfits.make_round(model, cfg)
    g_data = gen(2)
    return (lambda st, xs: round_fn(st, xs[1]), state,
            lambda t: fed.data_fn(t, g_data), ())


def async_round(args, dev, gen, fed=None, telemetry=False):
    """The buffered-async engine's round (``chip_smoke.py`` phase 5), its
    draws inside, as (body, state, batch_fn, generators); with
    ``telemetry`` the state carries the async counter column."""
    if args.compress != "none":
        raise SystemExit("--engine async is dense-uplink only")
    model = build(CNN_CONFIG)
    if fed is None:
        fed, _ = build_federation(0, kind="images", n=ASYNC_N,
                                  n_clients=ASYNC_M, dirichlet_alpha=1.0,
                                  batch_size=32, device=dev)
    cfg = FedConfig(n_clients=16, population=ASYNC_M, local_epochs=2,
                    local_lr=0.05, aggregator=args.aggregator,
                    async_max_retries=2, select_method="pallas")
    late = FaultConfig(straggler_frac=0.3, straggler_delay=3.0,
                       base_delay=0.3)
    draw, round_fn = async_engine.make_async_round(model, cfg, fed.data,
                                                   faults=late)
    state = async_engine.init_async_state(model.init(gen(0)), cfg, gen(1))
    if telemetry:
        state = state._replace(
            tele=obs_counters.init_column("async", cfg, dev))
    return (lambda st, xs: round_fn(st, draw(st)), state, lambda t: {}, ())


def scenario_round(args, dev, gen):
    """One round of a registry cell at paper-cnn width (``chip_smoke.py``
    phase 6b) as (body, state, batch_fn, generators)."""
    s = scenario_engine.setup(args.scenario, n_clients=16, kind="images",
                              arch="paper-cnn", device=dev)
    sc = s.scenario
    fed, _ = build_federation(0, kind="images", n=4000,
                              n_clients=s.population, batch_size=32, sep=1.0,
                              dirichlet_alpha=1.0, device=dev)
    kw = dict(data_attack=s.data_attack, update_attack=s.update_attack,
              malicious=s.malicious, faults=sc.faults)
    attacker = s.update_attack if getattr(s.update_attack, "stateful", False) \
        else None
    params = s.model.init(gen(0))
    if sc.async_mode:
        draw, round_fn = async_engine.make_async_round(
            s.model, s.fed_cfg, fed.data, batch_size=fed.batch_size,
            eval_batch=fed.eval_batch, straggler_rows=sc.straggler_rows,
            **kw)
        state = async_engine.init_async_state(params, s.fed_cfg, gen(1),
                                              attacker=attacker)
        return (lambda st, xs: round_fn(st, draw(st)), state, lambda t: {},
                ())
    round_fn = fedfits.make_round(s.model, s.fed_cfg, **kw)
    state = fedfits.init_state(params, 16, s.fed_cfg, gen(1),
                               attacker=attacker)
    g_data = gen(2)
    return (lambda st, xs: round_fn(st, xs[1]), state,
            lambda t: fed.data_fn(t, g_data), ())


def _stepper(body, state, batch_fn, generators, driver, telemetry):
    """``step(t)``: round t under ``driver``, and ``chunk(t0, n)`` (scan:
    n rounds as one chunk, returning its rows; ``telemetry`` observes
    them)."""
    box = [state]
    if driver == "python":
        def step(t):
            box[0], _ = body(box[0], (t, batch_fn(t)))
        return step, None
    drv = ScanDriver(body, chunk_steps=ROUNDS, generators=generators)

    def chunk(t0, n):
        box[0], rows = drv.run(box[0], batch_fn, n, t0=t0, index_key="round",
                               telemetry=telemetry)
        return rows
    return (lambda t: chunk(t, 1)), chunk


def measure(body, state, batch_fn, generators=(), *, driver="python",
            device, telemetry=None):
    """Times and traces ``body``'s round under ``driver`` on ``device``
    (module docstring), the scan driver's rows to ``telemetry``; returns a
    dict of the figures."""
    dev = torch.device(device)
    step, chunk = _stepper(body, state, batch_fn, generators, driver,
                           telemetry)
    walls = []
    for t in range(1, ROUNDS + 3):
        _sync(dev)
        t0 = time.perf_counter()
        step(t)
        _sync(dev)
        if t > 2:                                 # rounds 1-2: warm-up
            walls.append((time.perf_counter() - t0) * 1e3)
    out = {"driver": driver, "walls": walls,
           "median_ms": statistics.median(walls)}
    t_next = ROUNDS + 3
    if chunk is not None:
        rows = chunk(t_next, ROUNDS)
        out["chunk_round_ms"] = rows[0]["wall_ms"]
        t_next += ROUNDS

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(t_next)
        _sync(dev)
        traced_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device_ev = [e for e in events if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation]
    busy = busy_ms(device_ev)
    by_kernel = {}
    for e in device_ev:
        n, c = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (n + e.self_device_time_total / 1e3, c + 1)
    out.update(
        traced_ms=traced_ms, busy_ms=busy,
        kernel_ms=sum(e.self_device_time_total for e in device_ev) / 1e3,
        idle=1.0 - busy / traced_ms, device_events=len(device_ev),
        host_launches=sum(1 for e in events
                          if e.device_type == DeviceType.CPU
                          and any(k in e.name for k in HOST_LAUNCHES)),
        by_kernel=by_kernel,
        spans={s: sum(e.device_time_total for e in events
                      if e.name == s and e.device_type == DeviceType.CPU)
               / 1e3 for s in SPANS} if driver == "python" else None)
    return out


def report(out):
    """Prints ``measure``'s figures."""
    walls = out["walls"]
    line = (f"round wall ms ({out['driver']}): median "
            f"{out['median_ms']:.3f} over {len(walls)} rounds (min "
            f"{min(walls):.3f}, max {max(walls):.3f})")
    if "chunk_round_ms" in out:
        line += (f"; {out['chunk_round_ms']:.3f} a round over a chunk of "
                 f"{ROUNDS}")
    print(line)
    print(f"traced round: wall {out['traced_ms']:.3f} ms, device busy "
          f"{out['busy_ms']:.3f} ms (kernel and copy times summed "
          f"{out['kernel_ms']:.3f}), idle share {out['idle']:.3f}, "
          f"{out['device_events']} device events, {out['host_launches']} "
          "launches from the host")
    for s, ms in (out["spans"] or {}).items():
        print(f"  span {s:<14} device {ms:.3f} ms")
    by_kernel = out["by_kernel"]
    for fam, marks in OWN_KERNELS.items():
        own = sum(ms for k, (ms, _) in by_kernel.items()
                  if any(o in k for o in marks))
        print(f"  port's CUDA kernels {fam:<15} device {own:.3f} ms (not "
              "under a span)")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    for k, (ms, c) in top:
        print(f"  kernel {ms:9.3f} ms  x{c:<4} {k[:110]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", default="sync", choices=["sync", "async"])
    ap.add_argument("--aggregator", default="fedavg",
                    choices=["fedavg", "trimmed_mean", "median", "krum"])
    ap.add_argument("--compress", default="none", choices=COMPRESS)
    ap.add_argument("--scenario", default=None,
                    choices=sorted(registry.all_scenarios()), metavar="NAME",
                    help="one round of this registry cell instead")
    ap.add_argument("--driver", default="python", choices=["python", "scan"])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    if args.scenario:
        setup = scenario_round(args, dev, gen)
    else:
        setup = (async_round if args.engine == "async" else sync_round)(
            args, dev, gen)
    out = measure(*setup, driver=args.driver, device=dev)
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    if args.scenario:
        sc = registry.get(args.scenario)
        print(f"device {name}, scenario {sc.name}: engine "
              f"{'async' if sc.async_mode else 'sync'}, attack {sc.attack}, "
              f"aggregator {sc.aggregator}, compress {sc.compress}, driver "
              f"{args.driver}")
    else:
        print(f"device {name}, engine {args.engine}, aggregator "
              f"{args.aggregator}, compress {args.compress}, driver "
              f"{args.driver}")
    report(out)


if __name__ == "__main__":
    main()
