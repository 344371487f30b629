"""End-to-end federated training driver: the port of
``repro/launch/train.py``, with every flag of it and ``--device``.

Runs the PodEngine (``core/pod.py``): FedFiTS client groups on the rows of
each global batch, one training step a round.  With the default tiny-lm
config this trains a ~64M-parameter decoder on synthetic non-IID LM data.
The state is placed over the (``--data-axis``, ``--model-axis``) mesh of
the process group by ``sharding.specs.param_specs`` (FSDP x TP; world size
1 unless the launcher started a wider one, ``launch.mesh.start_group``);
on a mesh of one rank it stays plain.
``--robust per_client`` takes each client's grads and aggregates them
through the Eq.-11 kernels, sharded over that mesh; ``--compress
int8`` sends them through the int8 codec with error feedback and the
fused-dequant kernels; ``--aggregator`` (not a flag of the JAX CLI, which
trains with fedavg) picks the aggregator.  Runs on the card unless
``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-lm \\
      --steps 50 --global-batch 16 --seq 256 --clients 4 \\
      [--robust per_client] [--ckpt-dir DIR]

``--arch`` takes every name of ``configs.registry.ARCHS`` (e.g.
``granite-moe-1b-a400m``: its MoE layers' aux loss enters the weighted
loss; musicgen trains on frame embeddings, a VLM with patch embeddings).

Prints a JSON row every 5 steps and the last, then ``done``.  ``main``
returns ``(final_state, history)`` to a caller in the same process, the
state gathered whole.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import pod
from repro_torch.data import synthetic
from repro_torch.launch import inputs
from repro_torch.launch.mesh import host_mesh
from repro_torch.models import transformer
from repro_torch.optim import optimizers
from repro_torch.sharding import dtensor
from repro_torch.sharding import specs as sh

POOL = 64           # sequences in each client's pool


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def synthetic_lm_batches(cfg, tc, n_clients, seed, device):
    """Per-client non-IID LM streams: each client group draws from its own
    latent Markov mixture component (label-skew analogue for LM data).
    Returns ``sample(step)``: the step's batch, drawn from a generator
    seeded by (seed, step) alone, so a resumed run draws the batches of
    an uninterrupted one.

    The frontend stubs (``launch/inputs.py``): a model that reads
    embeddings (``embed_inputs=False``, musicgen) gets each input token's
    row of a fixed random frame table in place of the token; a VLM gets
    random patch embeddings (B, n_image_tokens, d) a step."""
    gb, s, d = tc.global_batch, tc.seq_len, cfg.d_model
    pools = torch.stack([
        synthetic.make_lm_tokens(_gen(device, seed * 1000 + c), POOL,
                                 s + 1, cfg.vocab_size, n_latent=2)
        for c in range(n_clients)])                 # (C, POOL, S + 1)
    bc = gb // n_clients
    rows = torch.arange(n_clients, device=device)[:, None]
    frames = None if cfg.embed_inputs else torch.randn(
        cfg.vocab_size, d, generator=_gen(device, seed + 2), device=device)
    vlm = cfg.arch_type == "vlm"

    def sample(step):
        g = _gen(device, (seed + 1) * 1_000_003 + step)
        idx = torch.randint(0, POOL, (n_clients, bc), generator=g,
                            device=device)
        seqs = pools[rows, idx].reshape(gb, s + 1)
        batch = {"targets": seqs[:, 1:]}
        if frames is None:
            batch["tokens"] = seqs[:, :-1]
        else:
            batch["embeds"] = frames[seqs[:, :-1]]
        if vlm:
            batch["image_embeds"] = torch.randn(
                gb, cfg.n_image_tokens, d, generator=g, device=device)
        return batch

    spec = lambda *shape, dtype=torch.float32: inputs.ShapeDtype(shape,
                                                                 dtype)
    sample.specs = {"targets": spec(gb, s, dtype=torch.int64)}
    if frames is None:
        sample.specs["tokens"] = spec(gb, s, dtype=torch.int64)
    else:
        sample.specs["embeds"] = spec(gb, s, d)
    if vlm:
        sample.specs["image_embeds"] = spec(gb, cfg.n_image_tokens, d)
    return sample


def make_telemetry(args, run_name="run"):
    """--trace/--telemetry-jsonl/--profile-dir -> an ``obs.Telemetry`` (or
    None when no obs output was requested; the scenario path still
    attaches its default in-memory telemetry then)."""
    from repro_torch import obs

    sinks = []
    if args.telemetry_jsonl:
        sinks.append(obs.JsonlSink(args.telemetry_jsonl))
    if not (args.telemetry_jsonl or args.trace or args.profile_dir):
        return None
    return obs.Telemetry(sinks=sinks, trace_path=args.trace,
                         profiler_dir=args.profile_dir, run_name=run_name)


def run_scenario_cli(args):
    """--scenario: one robustness-registry cell through the SimEngine."""
    from repro_torch.scenarios import run_scenario

    rounds = min(args.steps, 50)        # SimEngine rounds, not LM steps
    telemetry = make_telemetry(args, run_name=args.scenario)
    kw = dict(n_clients=args.clients, n_rounds=rounds, driver=args.driver,
              chunk_rounds=args.chunk_rounds, population=args.population,
              async_deadline=args.async_deadline, device=args.device)
    if telemetry is not None:
        with telemetry.profiled():
            summary, hist = run_scenario(args.scenario, telemetry=telemetry,
                                         **kw)
    else:
        summary, hist = run_scenario(args.scenario, **kw)
    for h in hist:
        print(json.dumps({
            "round": int(h["round"]),
            "test_acc": round(float(h["test_acc"]), 4),
            "trigger_acc": round(float(h["trigger_acc"]), 4),
            "fair_worst_decile": round(float(h["fair_worst_decile"]), 4),
            "fair_part_gini": round(float(h["fair_part_gini"]), 4),
            "gated_frac": round(float(h["gated_frac"]), 4),
        }))
    print(json.dumps(summary))


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tiny-lm")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test reduced arch variant")
    ap.add_argument("--robust", default=None, choices=[None, "per_client"],
                    help="per_client: coordinate-robust aggregation over "
                         "per-client grads, mesh-sharded along the "
                         "flattened param axis")
    ap.add_argument("--aggregator", default="fedavg",
                    choices=["fedavg", "trimmed_mean", "median", "krum"],
                    help="the Eq.-11 aggregator of --robust per_client "
                         "(FedConfig.aggregator; the JAX CLI fixes fedavg)")
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "int4", "signsgd", "topk"],
                    help="client->server transport codec: per-client grads "
                         "cross the boundary encoded, with EF residuals in "
                         "the state; int8 aggregates straight from the wire "
                         "codes (fused dequant). Requires --robust "
                         "per_client")
    ap.add_argument("--driver", default="scan", choices=["scan", "python"],
                    help="scan: chunked steps (on the card the step is "
                         "captured once as a CUDA graph and replayed); "
                         "python: the per-step loop (parity oracle)")
    ap.add_argument("--chunk-rounds", type=int, default=8)
    ap.add_argument("--scenario", default=None,
                    help="run a named robustness scenario (e.g. "
                         "alie_fedavg, gate_aware_trimmed, "
                         "gate_aware_int8_dropout) through the SimEngine "
                         "instead of the pod LM trainer; --steps sets the "
                         "round count and --clients the cohort size")
    ap.add_argument("--population", type=int, default=None,
                    help="register this many clients and route the "
                         "--scenario run through the buffered-async engine "
                         "(core/async_engine.py). Only meaningful with "
                         "--scenario")
    ap.add_argument("--trace", default=None, metavar="OUT_JSON",
                    help="write a Chrome/Perfetto trace-event JSON for the "
                         "run (validate with python -m repro_torch.obs.check)")
    ap.add_argument("--telemetry-jsonl", default=None, metavar="OUT_JSONL",
                    help="stream the obs metric rows and drift-monitor "
                         "warnings as JSON lines")
    ap.add_argument("--profile-dir", default=None,
                    help="wrap the run in a torch.profiler trace written "
                         "to DIR")
    ap.add_argument("--async-deadline", type=float, default=None,
                    help="per-round delivery deadline of the buffered-async "
                         "engine. Forces the --scenario cell through the "
                         "async engine, like --population")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)

    if (args.population or args.async_deadline) and not args.scenario:
        ap.error("--population/--async-deadline drive the buffered-async "
                 "SimEngine and need --scenario (e.g. "
                 "--scenario async_hetero)")
    if (args.population or args.async_deadline) and args.scenario:
        from repro_torch.scenarios import registry as scen_registry
        try:
            sc = scen_registry.get(args.scenario)
        except KeyError:
            sc = None                 # unknown name: run_scenario reports it
        if sc is not None and sc.compress != "none":
            ap.error(f"--scenario {args.scenario} is a compressed-uplink "
                     f"cell (compress={sc.compress}), but the buffered-"
                     "async engine (--population/--async-deadline) is "
                     "dense-uplink only — drop those flags to run the "
                     "cell on the sync engine, or pick a dense cell "
                     "(e.g. async_hetero)")

    dev = device_mod.resolve(args.device)
    if args.scenario:
        run_scenario_cli(args)
        return None

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.compress != "none" and args.robust != "per_client":
        ap.error("--compress needs --robust per_client (only that path "
                 "moves per-client updates across the wire)")
    fed = FedConfig(n_clients=args.clients, compress=args.compress,
                    aggregator=args.aggregator)
    tc = TrainConfig(global_batch=args.global_batch, seq_len=args.seq,
                     lr=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1))

    with host_mesh(args.data_axis, args.model_axis, device=dev) as mesh:
        return _train(args, cfg, fed, tc, dev, mesh)


def _train(args, cfg, fed, tc, dev, mesh):
    agg_mesh = mesh if args.robust else None
    params = transformer.init_transformer(_gen(dev, tc.seed), cfg)
    opt_init, _ = optimizers.make_optimizer(tc)
    # the state placed over data x model by param_specs (FSDP x TP), as
    # the JAX CLI places it.  On one rank placing moves nothing and costs
    # DTensor's host dispatch on every op of an eager step (2.5x the plain
    # per-step loop on the H100), so the state stays plain there
    state_sh = ((lambda st: sh.named(mesh, sh.param_specs(st, mesh=mesh)))
                if mesh.size > 1 else None)
    state = pod.init_pod_state(params, opt_init, fed.n_clients, fed,
                               _gen(dev, tc.seed + 1), mesh=agg_mesh,
                               shardings=state_sh)
    del params
    step_fn = pod.make_train_step(cfg, fed, tc, robust=args.robust,
                                  agg_mesh=agg_mesh)

    start = 0
    if args.ckpt_dir:
        restored, at = ckpt.restore_latest(
            args.ckpt_dir, state, state_sh(state) if state_sh else None)
        if restored is not None:
            state, start = restored, at
            print(f"restored checkpoint at step {at}")

    # scan-driver checkpoints happen at chunk ends (mid-chunk states never
    # exist host-side): align the chunk size to the checkpoint cadence so
    # a crash loses at most ckpt_every-1 steps, like the python driver
    chunk_rounds = args.chunk_rounds
    if args.ckpt_dir and args.driver == "scan":
        chunk_rounds = min(chunk_rounds, args.ckpt_every)
        if args.ckpt_every % chunk_rounds:
            print(f"# note: ckpt-every {args.ckpt_every} not divisible by "
                  f"chunk-rounds {chunk_rounds}; saves land on the first "
                  f"chunk end at/after each due step")

    sampler = synthetic_lm_batches(cfg, tc, fed.n_clients, tc.seed, dev)
    # each rank stages only its data index's rows
    batch_sh = inputs.batch_shardings(sampler.specs, mesh)
    t0 = time.time()

    def on_chunk(st, rows):
        for row in rows:
            step = row["step"]
            if step % 5 == 0 or step == args.steps - 1:
                m = {k: round(float(v), 4) for k, v in row.items()
                     if k != "step"}
                m["step"] = step
                m["wall_s"] = round(time.time() - t0, 1)
                print(json.dumps(m))
        last = rows[-1]["step"]
        if args.ckpt_dir and any((r["step"] + 1) % args.ckpt_every == 0
                                 for r in rows):
            ckpt.save_step(args.ckpt_dir, last + 1, st)

    telemetry = make_telemetry(args, run_name=args.arch)
    kw = dict(driver=args.driver, chunk_rounds=chunk_rounds,
              batch_sharding=batch_sh, t0=start, on_chunk=on_chunk)
    if telemetry is not None:
        with telemetry.profiled():
            out = pod.run(state, step_fn, sampler, args.steps - start,
                          telemetry=telemetry, **kw)
        telemetry.finish()
    else:
        out = pod.run(state, step_fn, sampler, args.steps - start, **kw)
    print("done")
    # whole tensors, usable after the process group is gone
    state, history = out
    return dtensor.whole(state), history


if __name__ == "__main__":
    main()
