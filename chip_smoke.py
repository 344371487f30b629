#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failure raises, so the exit code is not 0):
  1. card     nvidia-smi's name and power limit, the device, the build of
              every CUDA kernel from src/repro_torch/csrc (nvcc, sm_90a).
  2. kernels  each kernel against its plain PyTorch version on the card,
              at the main path's shape (G=1, C=16, N=421,642) and at
              (G=2, C=64, N=65,573) with ragged N, an empty cohort and a
              one-member cohort; times by CUDA events.
  3. round    the port's main path: the full-width paper-cnn FedFiTS round
              through ``fedfits.run``, 10 rounds under fedavg, then 2 each
              under trimmed_mean, median and krum; every kernel must have
              launched; round 1 is run again through the CPU port and must
              give the same team and the same params.
The last three lines are the nvidia-smi line, the kernels JSON and the
result JSON.  Without a CUDA device, or without the repository's
src/repro_torch beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM data-sheet peaks: HBM bytes/s and
# fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# tolerances, kernel vs plain version on the same card.  The median picks
# entries, so it is bitwise.  Per-column sums over C clients (mean,
# trimmed) keep the tests' rtol 1e-5 / atol 1e-6.  Sums over N columns
# (cosine partials, Gram) reduce ~4e5 terms in other orders, so they are
# held at 1e-5 of the largest magnitude.
RTOL, ATOL = 1e-5, 1e-6
NSUM_REL = 1e-5
# round 1 on the card vs on the CPU: conv and matmul in other orders
ROUND1_ATOL = 1e-5

TIMED_CALLS = 20
SLICE_SHAPE = (1, 16, 421_642)
WIDE_SHAPE = (2, 64, 65_573)
TPU_KERNELS = {   # name -> (file:line of the Pallas kernel it replaces)
    "cosine_gate_partials":
        "src/repro/kernels/robust_pipeline.py:280",
    "gated_combine": "src/repro/kernels/robust_pipeline.py:398",
    "pairwise_gram": "src/repro/kernels/robust_pipeline.py:494",
}
CUDA_SOURCE = "src/repro_torch/csrc/robust_pipeline.cu"


def bound(bytes_moved, ops):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and fp32
    operations over the fp32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_work(name, g, c, n, mode=None):
    """Bytes each kernel must move (inputs read once, outputs written once)
    and the operations it does: C^2 compares per column for the rank
    network, 2 flops per multiply-add."""
    x = 4 * g * c * n
    if name == "cosine_gate_partials":
        return x + 4 * g * c + 4 * g * (2 * c + 1), \
            g * n * (c * c + 4 * c + 2)
    if name == "pairwise_gram":
        return x + 4 * g * c * c, 2 * g * c * c * n
    ops = 2 * g * c * n if mode == "mean" else g * n * (c * c + 2 * c)
    return x + 8 * g * c + 4 * g * n, ops


def time_ms(fn):
    """Mean device time of one call by CUDA events, after a warm-up.  The
    (C, N) matrix stays in L2 between calls, as it does in the round,
    where the guard has just read it."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(TIMED_CALLS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / TIMED_CALLS


def _import_port():
    if not (SRC / "repro_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py: src/repro_torch not found beside "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, str(SRC))


def _card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    regs = [l.strip() for l in _build.build_log().splitlines()
            if "registers" in l]
    print(f"[card] {smi} | {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | kernels built in "
          f"{time.perf_counter() - t0:.1f} s")
    for r in regs:
        print(f"[card] ptxas {r}")
    return smi


def _check(name, out, ref, exact=False, rel=None):
    import torch
    err = float((out - ref).abs().max())
    if exact:
        ok = torch.equal(out, ref)
    elif rel is not None:
        ok = err <= rel * float(ref.abs().max())
    else:
        ok = bool(torch.allclose(out, ref, rtol=RTOL, atol=ATOL))
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


def _inputs(shape, seed, masks):
    import numpy as np
    import torch
    g, c, n = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape, np.float32) * 1e-2)
    mask = torch.from_numpy(np.asarray(masks, np.float32))
    w = torch.from_numpy(rng.uniform(0.1, 1.0, (g, c)).astype(np.float32))
    w = w * mask
    w = w / w.sum(1, keepdim=True).clamp(min=1e-12)
    return x.cuda(), mask.cuda(), w.cuda()


def _kernels():
    """Phase 2: every kernel against its plain version; returns the report
    entries (times at the main path's shape)."""
    import torch
    from repro_torch.kernels import robust_pipeline as rp

    g, c, n = WIDE_SHAPE
    normal = [1.0] * c
    normal[5] = 0.0
    lone = [0.0] * c
    lone[7] = 1.0
    cases = [(SLICE_SHAPE, [[1.0] * SLICE_SHAPE[1]]),
             (WIDE_SHAPE, [normal, [0.0] * c]),       # empty cohort
             (WIDE_SHAPE, [lone, normal])]            # one-member cohort
    errs = {}
    for shape, masks in cases:
        x, m, w = _inputs(shape, sum(shape), masks)
        outs = rp.cosine_gate_partials(x, m)
        refs = rp.cosine_gate_partials_plain(x, m)
        for part, o, r in zip(("dots", "sqnorms", "refsq"), outs, refs):
            e = _check(f"cosine_gate_partials/{part} {shape}", o, r,
                       rel=NSUM_REL)
            errs["cosine_gate_partials"] = max(
                errs.get("cosine_gate_partials", 0.0), e)
        for mode in rp.MODES:
            o = rp.gated_combine(x, m, w, mode=mode)
            r = rp.gated_combine_plain(x, m, w, mode=mode)
            key = f"gated_combine[{mode}]"
            errs[key] = max(errs.get(key, 0.0), _check(
                f"{key} {shape}", o, r, exact=mode == "median"))
            if len(masks) == 2 and masks[1] == [0.0] * c \
                    and float(o[1].abs().max()) != 0.0:
                raise AssertionError(f"{key}: empty cohort is not zero")
            if masks[0] == lone:
                _check(f"{key} lone", o[0], x[0, 7], exact=mode == "median")
        e = _check(f"pairwise_gram {shape}", rp.pairwise_gram(x),
                   rp.pairwise_gram_plain(x), rel=NSUM_REL)
        errs["pairwise_gram"] = max(errs.get("pairwise_gram", 0.0), e)
        torch.cuda.synchronize()
        print(f"[kernels] {shape} masks={[int(sum(r)) for r in masks]}: "
              "all kernels agree with their plain versions")

    g, c, n = SLICE_SHAPE
    x, m, w = _inputs(SLICE_SHAPE, 0, [[1.0] * c])
    calls = {
        "cosine_gate_partials": (
            lambda: rp.cosine_gate_partials(x, m),
            lambda: rp.cosine_gate_partials_plain(x, m), None),
        "gated_combine[mean]": (
            lambda: rp.gated_combine(x, m, w, mode="mean"),
            lambda: rp.gated_combine_plain(x, m, w, mode="mean"),
            lambda: torch.matmul(w[:, None, :], x)),
        "gated_combine[trimmed]": (
            lambda: rp.gated_combine(x, m, m, mode="trimmed"),
            lambda: rp.gated_combine_plain(x, m, m, mode="trimmed"), None),
        "gated_combine[median]": (
            lambda: rp.gated_combine(x, m, m, mode="median"),
            lambda: rp.gated_combine_plain(x, m, m, mode="median"), None),
        "pairwise_gram": (
            lambda: rp.pairwise_gram(x),
            lambda: rp.pairwise_gram_plain(x),
            lambda: torch.bmm(x, x.transpose(1, 2))),
    }
    report = []
    for name, (kern, plain, lib) in calls.items():
        base, _, mode = name.partition("[")
        b, ops = kernel_work(base, g, c, n, mode.rstrip("]") or None)
        bound_ms, bound_by = bound(b, ops)
        entry = {"name": name, "route": "cuda", "source": CUDA_SOURCE,
                 "replaces": TPU_KERNELS[base], "launches": None,
                 "max_abs_err": errs[name], "ms": time_ms(kern),
                 "plain_ms": time_ms(plain), "bound_ms": bound_ms,
                 "bound_by": bound_by,
                 "library_ms": time_ms(lib) if lib else None}
        print(f"[kernels] {name} {SLICE_SHAPE}: {entry['ms']:.4f} ms, plain "
              f"{entry['plain_ms']:.4f} ms, library {entry['library_ms']}, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        report.append(entry)
    return report


def _round():
    """Phase 3: the port's main path; returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.paper_models import CNN_CONFIG
    from repro_torch.core import fedfits
    from repro_torch.data.pipeline import build_federation
    from repro_torch.kernels import robust_pipeline as rp
    from repro_torch.models.model import build

    model = build(CNN_CONFIG)
    fed, test = build_federation(0, kind="images", n=4000, n_clients=16,
                                 batch_size=32)

    def evaluate(params):
        _, met = model.loss(params, test)
        return {"test_acc": met["acc"]}

    cap = {}
    clone = lambda p: tree.map(lambda t: t.detach().clone(), p)

    def init(gen):
        cap["init"] = clone(model.init(gen))
        return clone(cap["init"])

    def data_fn(t, gen):
        batch = fed.data_fn(t, gen)
        cap.setdefault("batch", batch)
        return batch

    def eval_first(params):
        cap.setdefault("params1", clone(params))
        return evaluate(params)

    cfg = lambda agg: FedConfig(n_clients=16, algorithm="fedfits",
                                local_epochs=2, local_lr=0.05, msl=4,
                                pft=2, aggregator=agg)
    rp.reset_launch_counts()
    first = None
    for agg, rounds in [("fedavg", 10), ("trimmed_mean", 2), ("median", 2),
                        ("krum", 2)]:
        if agg == "fedavg":
            state, hist = fedfits.run(
                dataclasses.replace(model, init=init), cfg(agg), data_fn,
                rounds, 0, eval_fn=eval_first)
            first = hist
        else:
            state, hist = fedfits.run(model, cfg(agg), fed.data_fn, rounds,
                                      0, eval_fn=evaluate)
        for h in hist:
            team = "".join("#" if v else "." for v in h["team"])
            print(f"[round] {agg:<12} {h['round']:>2} team[{team}] "
                  f"alpha={float(h['alpha']):.3f} "
                  f"test_acc={float(h['test_acc']):.4f} "
                  f"wall_ms={h['wall_ms']:.2f}")
        if not all(bool(torch.isfinite(l).all())
                   for l in tree.leaves(state.params)):
            raise AssertionError(f"{agg}: non-finite params")
    torch.cuda.synchronize()
    counts = rp.launch_counts()
    print(f"[round] launches {json.dumps(counts)}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    acc0, acc_end = float(first[0]["test_acc"]), float(first[-1]["test_acc"])
    if not acc_end > acc0:
        raise AssertionError(f"fedavg test_acc did not improve: {acc0} -> "
                             f"{acc_end}")

    # round 1 again through the CPU port, same params and batch
    cpu = lambda p: tree.map(lambda t: t.cpu(), p)
    state = fedfits.init_state(cpu(cap["init"]), 16, cfg("fedavg"),
                               torch.Generator().manual_seed(1))
    state, met = fedfits.make_round(model, cfg("fedavg"))(
        state, cpu(cap["batch"]))
    if not np.array_equal(met["team"].numpy(), first[0]["team"]):
        raise AssertionError("round 1: CPU and card teams differ")
    diff = max(float((a - b.cpu()).abs().max()) for a, b in zip(
        tree.leaves(state.params), tree.leaves(cap["params1"])))
    print(f"[round] round 1 on the CPU port: same team, params max abs diff "
          f"{diff:.3e} (atol {ROUND1_ATOL})")
    if diff > ROUND1_ATOL:
        raise AssertionError("round 1: CPU and card params differ")
    return counts


def main():
    _import_port()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    smi = _card()
    report = _kernels()
    counts = _round()
    for entry in report:
        entry["launches"] = counts[entry["name"]]
    print(smi)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
