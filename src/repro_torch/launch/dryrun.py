"""Dry-run of the sharded step (port of ``repro/launch/dryrun.py``): every
(architecture x input shape) on the production mesh, counted per chip
with nothing allocated.

The reference lowers and compiles each step for 256 (512) placeholder TPU
devices and reads XLA's memory and cost analyses.  The port has no
compiler to ask, so it runs the step once: the state and inputs are fake
CPU tensors (``FakeTensorMode``: shapes, dtypes and strides, no storage),
placed as DTensors by the ``sharding/specs.py`` layouts on a mesh over a
fake process group of 256 (512) ranks (``launch/mesh.make_production_mesh``;
this process is rank 0, and a collective moves nothing), and
``roofline.CostCounter`` counts this rank's aten ops as they run: flops,
bytes, collective bytes by kind and the peak of live storage.  No card
is used or needed; the figures are counts and modeled seconds, not
measurements.  "Compiled" in the summary line means "ran on fake
tensors", and ``compile_s`` is the wall time of that run.  It is the one
entry point of the port that does not run on ``cuda``; a kernel wrapper
reached by a fake tensor raises.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
      --shape train_4k [--multi-pod] [--json out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from typing import NamedTuple

import torch

from repro_torch import tree
from repro_torch.configs.base import INPUT_SHAPES, FedConfig, TrainConfig
from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.core import pod
from repro_torch.launch import inputs as inputs_lib
from repro_torch.launch import roofline as roof
from repro_torch.launch.mesh import fake_group, make_production_mesh
from repro_torch.models import attention, transformer
from repro_torch.models.layers import SHAPE_ONLY
from repro_torch.models.model import build
from repro_torch.optim import optimizers
from repro_torch.sharding import dtensor
from repro_torch.sharding import specs as sh

class Lowered(NamedTuple):
    """What the reference reads off its compiled step: the per-chip cost
    (``cost_analysis()``'s flops and bytes), the collective bytes by kind
    and the memory record (``memory_analysis()``'s four sizes)."""
    cost: dict
    collectives: dict
    memory: dict


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def _fake_like(t):
    """Zeros of each meta leaf's shape and dtype: fake CPU tensors under
    the dry-run's fake mode (the step reads no value of them)."""
    return tree.map(lambda x: torch.zeros(tuple(x.shape), dtype=x.dtype), t)


def _params_struct(cfg):
    return transformer.init_transformer(SHAPE_ONLY, cfg)


def _placed(t, spec_fn, mesh):
    return dtensor.place(t, sh.named(mesh, spec_fn(t, mesh=mesh)))


@contextlib.contextmanager
def _alltoall_as_on_the_card():
    """DTensor's Shard(i) -> Shard(j) redistribution falls back to an
    all-gather and a chunk on a "cpu" mesh (gloo has no all_to_all), where
    the card's NCCL mesh runs one all_to_all.  The dry-run's mesh is a
    "cpu" one over a fake group, so within this context the redistribution
    takes the card's op (its fake kernel moves nothing)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import placement_types as pt

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))

    inner = pt.shard_dim_alltoall
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = inner


def _count(fn, *args):
    """``fn(*args)`` under a ``CostCounter`` that starts with ``args``
    live; returns (its output, the ``Lowered`` record)."""
    counter = roof.CostCounter()
    arg_bytes = counter.track(*args)
    with _alltoall_as_on_the_card(), counter:
        out = fn(*args)
    out_bytes = sum(_local_bytes(x) for x in tree.leaves(out)
                    if isinstance(x, torch.Tensor))
    cost, coll = counter.costs()
    return out, Lowered(cost, coll, {
        "argument_bytes": arg_bytes, "output_bytes": out_bytes,
        "temp_bytes": counter.peak_bytes - arg_bytes,
        "peak_bytes": counter.peak_bytes})


def _local_bytes(x):
    x = dtensor.local(x)
    return x.numel() * x.element_size()


def _dp_groups(mesh):
    n = 1
    for ax in ("pod", "data"):
        if ax in mesh.axis_names:
            n *= mesh.shape[mesh.axis_names.index(ax)]
    return n


def train_setup(cfg, shape_name, mesh, params, variant="baseline",
                n_clients=None, robust=None):
    """The placed train state, this rank's batch rows and the step, as
    ``lower_train`` runs them, from ``params`` (fake or real): C =
    min(data groups, global batch) clients (``n_clients`` overrides it),
    the state placed by ``param_specs`` (``param_specs_moe_ff`` under
    ``moe_ff`` / ``zero1_moe``), ZeRO-1's (compute, master) layouts under
    ``zero1`` / ``zero1_moe``; ``robust="per_client"`` takes the
    per-client step, aggregated over ``mesh``."""
    shape = inputs_lib._shape(shape_name)
    C = n_clients or min(_dp_groups(mesh), shape.global_batch)
    fed = FedConfig(n_clients=C)
    tc = TrainConfig(global_batch=shape.global_batch, seq_len=shape.seq_len)
    opt_init, _ = optimizers.make_optimizer(tc)
    dev = tree.leaves(params)[0].device
    state = pod.init_pod_state(params, opt_init, C, fed,
                               torch.Generator(device=dev))
    spec_fn = (sh.param_specs_moe_ff if variant in ("moe_ff", "zero1_moe")
               else sh.param_specs)
    state = pod.place_state(state, sh.named(mesh, spec_fn(state, mesh=mesh)))
    batch_s = inputs_lib.train_batch_specs(cfg, shape)
    named = sh.named(mesh, sh.batch_specs(batch_s, mesh))
    batch = {k: named[k].local(torch.zeros(v.shape, dtype=v.dtype,
                                           device=dev)).clone()
             for k, v in batch_s.items()}
    zero1 = None
    if variant in ("zero1", "zero1_moe"):
        compute, master = ((sh.param_specs_tp, sh.param_specs)
                           if variant == "zero1" else
                           (sh.param_specs_zero1_moe, sh.param_specs_moe_ff))
        zero1 = (sh.named(mesh, compute(params, mesh=mesh)),
                 sh.named(mesh, master(params, mesh=mesh)))
    step = pod.make_train_step(
        cfg, fed, tc, zero1_shardings=zero1, robust=robust,
        agg_mesh=mesh if robust == "per_client" else None)
    return state, batch, step


def lower_train(cfg, shape_name, mesh, variant="baseline", *,
                n_clients=None, robust=None):
    """One pod step (``robust=None``, or ``"per_client"``) on fake tensors
    over ``mesh``, counted; returns (``Lowered``, the params' meta
    tree)."""
    params_s = _params_struct(cfg)
    with _fake_mode():
        state, batch, step = train_setup(cfg, shape_name, mesh,
                                         _fake_like(params_s), variant,
                                         n_clients, robust)
        _, low = _count(step, state, batch)
    return low, params_s


def serve_setup(cfg, shape_name, mesh, params, variant="baseline", *,
                decode=False):
    """``params`` (fake or real) cast as the serving path casts them
    (``transformer.cast_params``: bf16 but the leaves read in fp32) and
    placed by ``param_specs`` (``param_specs_tp`` under ``tp_serve``), the
    serving batch and the stacked cache placed by ``batch_specs`` and
    ``cache_specs``."""
    params = transformer.cast_params(params, cfg.replace(dtype="bfloat16"))
    spec_fn = sh.param_specs_tp if variant == "tp_serve" else sh.param_specs
    params = _placed(params, spec_fn, mesh)
    dev = dtensor.local(tree.leaves(params)[0]).device
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
             for k, v in inputs_lib.infer_batch_specs(
                 cfg, shape_name, decode=decode).items()}
    batch = dtensor.place(batch, sh.named(mesh, sh.batch_specs(batch, mesh)))
    cache = tree.map(lambda x: torch.zeros(tuple(x.shape), dtype=x.dtype,
                                           device=dev),
                     inputs_lib.cache_specs_struct(cfg, shape_name))
    cache = dtensor.place(cache, sh.named(mesh, sh.cache_specs(cache, mesh)))
    return params, batch, cache


def lower_prefill(cfg, shape_name, mesh, variant="baseline"):
    """``Model.prefill`` on the placed params, batch and cache (fake),
    counted.  A fresh cache's ring position is 0, so the ring prefill's
    host check of it is left out (``attention.fresh_ring_caches``)."""
    model = build(cfg)
    params_s = _params_struct(cfg)
    with _fake_mode():
        params, batch, cache = serve_setup(cfg, shape_name, mesh,
                                           _fake_like(params_s), variant)
        with torch.no_grad(), attention.fresh_ring_caches():
            _, low = _count(model.prefill, params, batch, cache)
    return low, params_s


def lower_decode(cfg, shape_name, mesh, variant="baseline"):
    """``Model.decode`` of one token at a 0-d position on the placed
    params, batch and cache (fake), counted."""
    model = build(cfg)
    params_s = _params_struct(cfg)
    with _fake_mode():
        params, batch, cache = serve_setup(cfg, shape_name, mesh,
                                           _fake_like(params_s), variant,
                                           decode=True)
        pos = torch.zeros((), dtype=torch.int32)
        with torch.no_grad():
            _, low = _count(model.decode, params, batch, cache, pos)
    return low, params_s


PROBE_DEPTHS = (2, 4)


def _kind_probe_cfg(cfg, block_kind, n_layers_probe):
    """Probe variant: ``n_layers_probe`` layers of ONE block kind.

    The reference compiles two small unrolled probes per distinct block
    kind (1 and 2 layers), because HloCostAnalysis counts a while-loop body
    once, and composes

        cost_full = base + sum_kind n_kind * delta_kind,

    delta_kind the cost of one more layer of that kind, base the rest
    (embed / head / loss / fitness, the same for every kind).  The port's
    probes have PROBE_DEPTHS layers (2 and 4): a one-layer probe's stacked
    (1, ...) leaves take shortcuts a deeper stack does not (a gather of
    such a grad on dim 1 is a view there, ``_maybe_view_chunk_cat``, and a
    chunk-and-cat from two layers on), so on torch 2.11 the hybrid train
    stack composed from 1 and 2 layers came out 9,216 B above its full
    count.  From 2 and 4 it is exact.  The port counts every layer it
    runs, so ``run_one`` reports the full-depth count, which is exact; only
    ``perf.measure`` composes probes, to save the full-depth run.  The
    composition equals the full count for attn, moe, hybrid and xattn
    stacks; an xLSTM stack's layers cost differently by their place in it,
    and its train step composes within a few percent (ROADMAP §3)."""
    return cfg.replace(n_layers=n_layers_probe,
                       block_pattern=(block_kind,) * n_layers_probe,
                       scan_unroll=True)


def _lower_for(cfg, shape_name, mesh, kind, variant="baseline"):
    if kind == "train":
        return lower_train(cfg, shape_name, mesh, variant)
    if kind == "prefill":
        return lower_prefill(cfg, shape_name, mesh, variant)
    return lower_decode(cfg, shape_name, mesh, variant)


def _probe_costs(cfg, shape_name, mesh, kind, variant="baseline"):
    """Composed per-chip flops / bytes / collective bytes of the full
    depth, from a probe of PROBE_DEPTHS[0] and one of PROBE_DEPTHS[1]
    layers of each distinct block kind (``_kind_probe_cfg``)."""
    from collections import Counter

    kind_counts = Counter(cfg.layers)
    a, b = PROBE_DEPTHS

    def one_probe(block_kind, n_layers_probe):
        pcfg = _kind_probe_cfg(cfg, block_kind, n_layers_probe)
        low, _ = _lower_for(pcfg, shape_name, mesh, kind, variant)
        return (float(low.cost["flops"]), float(low.cost["bytes accessed"]),
                low.collectives)

    base_f = base_b = None
    base_c = None
    tot_f = tot_b = 0.0
    tot_c = {}
    for bk, n_bk in kind_counts.items():
        fa, ba, ca = one_probe(bk, a)
        fb, bb, cb = one_probe(bk, b)
        df, db = (fb - fa) / (b - a), (bb - ba) / (b - a)
        dc = {kk: (cb[kk] - ca[kk]) / (b - a) for kk in ca}
        if base_f is None:
            base_f, base_b = fa - a * df, ba - a * db
            base_c = {kk: ca[kk] - a * dc[kk] for kk in ca}
        tot_f += n_bk * df
        tot_b += n_bk * db
        for kk in ca:
            tot_c[kk] = tot_c.get(kk, 0.0) + n_bk * dc[kk]
    flops = max(base_f + tot_f, 0.0)
    byts = max(base_b + tot_b, 0.0)
    coll = {kk: max(base_c.get(kk, 0.0) + v, 0.0) for kk, v in tot_c.items()}
    return {"flops": flops, "bytes accessed": byts}, coll


def run_one(arch: str, shape_name: str, *, multi_pod=False, verbose=True,
            variant="baseline"):
    """One combination on the production mesh, over a fake group this
    function starts (and destroys): the full-depth step counted, and its
    count's roofline terms.  The reference composes its roofline from
    probes (``_probe_costs``) because XLA counts a loop body once; the
    port's count is already exact, so it has no ``probe`` option."""
    base = get_config(arch)
    cfg = inputs_lib.shape_variant(base, shape_name)
    shape = INPUT_SHAPES[shape_name]
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.time()
        low, params_s = _lower_for(cfg, shape_name, mesh, shape.kind,
                                   variant)
        dt = time.time() - t0
    terms = roof.roofline(low.cost, low.collectives)
    n_params = roof.count_params(params_s)
    mflops = roof.model_flops(cfg, n_params, shape, shape.kind)
    n_chips = mesh.size
    terms["model_flops_global"] = mflops
    terms["model_flops_per_chip"] = mflops / n_chips
    terms["useful_ratio"] = (mflops / n_chips) / max(terms["hlo_flops"], 1.0)
    result = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "mesh": "x".join(map(str, mesh.shape)),
        "kind": shape.kind,
        "n_params": n_params,
        "compile_s": round(dt, 1),
        "memory": dict(low.memory),
        **terms,
    }
    if verbose:
        print(json.dumps(result, indent=1, default=float))
    return result


def _combo(arch, shape, kw):
    """``run_one`` -> (result, None), or (None, the traceback)."""
    try:
        return run_one(arch, shape, verbose=False, **kw), None
    except Exception:
        return None, traceback.format_exc()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default=None, help="append results as jsonl")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "zero1", "tp_serve"])
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations run at once, each in a process of "
                    "its own (each starts its own fake group)")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ASSIGNED for s in INPUT_SHAPES]
    else:
        archs = [args.arch] if args.arch else ASSIGNED
        shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
        combos = [(a, s) for a in archs for s in shapes]

    kw = dict(multi_pod=args.multi_pod, variant=args.variant)
    if args.jobs > 1:
        import concurrent.futures as cf
        import multiprocessing as mp
        pool = cf.ProcessPoolExecutor(args.jobs,
                                      mp_context=mp.get_context("spawn"))
        runs = [pool.submit(_combo, arch, shape, kw)
                for arch, shape in combos]
        outcomes = (r.result() for r in runs)
    else:
        outcomes = (_combo(arch, shape, kw) for arch, shape in combos)
    ok, failed = 0, []
    for (arch, shape), (res, err) in zip(combos, outcomes):
        tag = f"{arch} x {shape} ({'2x16x16' if args.multi_pod else '16x16'})"
        print(f"==== {tag} ====", flush=True)
        if err is None:
            print(json.dumps(res, indent=1, default=float), flush=True)
            ok += 1
            if args.json:
                with open(args.json, "a") as f:
                    f.write(json.dumps(res, default=float) + "\n")
        else:
            print(err, file=sys.stderr, flush=True)
            failed.append(tag)
    print(f"\nDRY-RUN: {ok}/{len(combos)} combinations compiled")
    if failed:
        print("FAILED:", *failed, sep="\n  ")
        sys.exit(1)


if __name__ == "__main__":
    main()
