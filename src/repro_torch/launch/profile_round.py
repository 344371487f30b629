"""Where a round's time goes: the full-width paper-cnn FedFiTS round on the
card, timed on the host clock and traced by ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_round \
        [--aggregator A] [--compress C]

Runs the round of ``chip_smoke.py``'s main path (16 clients, batch 32,
2 local epochs), with the uplink codec ``--compress`` (none, int8, int4,
signsgd, topk, randk; error feedback on).  Prints the median round wall
time over 10 steady-state rounds (host clock, ending in a synchronize),
then traces one more round and prints: device busy time (the sum of kernel
and copy times) and the idle share of the traced wall time, the device
time under each phase span of the round (client_update, transport,
selection, sanitize, aggregate, writeback) and under the port's own CUDA
kernels (K1-K3 and K6a-c apart), and the kernels that take the most
device time.
Runs on the card unless ``--device cpu``.
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
from repro_torch.core import fedfits
from repro_torch.data.pipeline import build_federation
from repro_torch.models.model import build

ROUNDS = 10                 # timed steady-state rounds, after 2 warm-up
SPANS = ("client_update", "transport", "selection", "sanitize", "aggregate",
         "writeback")
# the port's own kernels launch through ctypes, outside any torch op, so the
# profiler does not attribute them to a span: they are summed by name.  K1-K3
# and K6a-c are the same templated kernels (pass1_partials, gated_combine,
# gram_partials) over two row sources; reduce_partials serves both.
OWN_KERNELS = {"K1-K3": ("DenseRows",), "K6a-c": ("QuantRows",),
               "reduce_partials": ("reduce_partials",)}
COMPRESS = ("none", "int8", "int4", "signsgd", "topk", "randk")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--aggregator", default="fedavg",
                    choices=["fedavg", "trimmed_mean", "median", "krum"])
    ap.add_argument("--compress", default="none", choices=COMPRESS)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    model = build(CNN_CONFIG)
    fed, _ = build_federation(0, kind="images", n=4000, n_clients=16,
                              batch_size=32, device=dev)
    cfg = FedConfig(n_clients=16, algorithm="fedfits", local_epochs=2,
                    local_lr=0.05, msl=4, pft=2, aggregator=args.aggregator,
                    compress=args.compress, error_feedback=True)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    state = fedfits.init_state(model.init(gen(0)), 16, cfg, gen(1))
    round_fn = fedfits.make_round(model, cfg)
    g_data = gen(2)

    walls = []
    for t in range(1, ROUNDS + 3):
        batch = fed.data_fn(t, g_data)
        _sync(dev)
        t0 = time.perf_counter()
        state, _ = round_fn(state, batch)
        _sync(dev)
        if t > 2:                                 # rounds 1-2: warm-up
            walls.append((time.perf_counter() - t0) * 1e3)

    batch = fed.data_fn(ROUNDS + 3, g_data)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        round_fn(state, batch)
        _sync(dev)
        traced_ms = (time.perf_counter() - t0) * 1e3

    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in SPANS]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    spans = {s: sum(e.device_time_total for e in events
                    if e.name == s and e.device_type == DeviceType.CPU) / 1e3
             for s in SPANS}
    by_kernel = {}
    for e in device:
        n, c = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (n + e.self_device_time_total / 1e3, c + 1)

    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(f"device {name}, aggregator {args.aggregator}, compress "
          f"{args.compress}")
    print(f"round wall ms: median {statistics.median(walls):.3f} over "
          f"{len(walls)} rounds (min {min(walls):.3f}, max {max(walls):.3f})")
    print(f"traced round: wall {traced_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / traced_ms:.3f}, {len(device)} device events")
    for s, ms in spans.items():
        print(f"  span {s:<14} device {ms:.3f} ms")
    for fam, marks in OWN_KERNELS.items():
        own = sum(ms for k, (ms, _) in by_kernel.items()
                  if any(o in k for o in marks))
        print(f"  port's CUDA kernels {fam:<15} device {own:.3f} ms (not "
              "under a span)")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    for k, (ms, c) in top:
        print(f"  kernel {ms:9.3f} ms  x{c:<4} {k[:110]}")


if __name__ == "__main__":
    main()
