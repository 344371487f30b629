"""Serving entry point (port of ``repro/launch/serve.py``): continuous
batching over the paged KV cache, with the fixed-batch engine and the
dense full-cache loop as baselines.  On the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \
      --requests 48 --max-slots 16 --page-size 16 --prompt-len 128 \
      --gen-min 16 --gen-max 256 [--engine continuous|fixed|dense] \
      [--kv-int8] [--attn pallas|ref]

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny-lm \
      --reduced --device cpu          # a CPU rehearsal

  ... --trace serve_trace.json --telemetry-jsonl serve.jsonl
                                      # telemetry: a row a decode step

``--arch`` takes every name of ``configs.registry.ARCHS`` whose model
reads tokens; the paged engines take stacks of ``attn`` and ``moe`` blocks
(e.g. ``granite-moe-1b-a400m``), the dense loop every block kind.

Engines:
  continuous  slot scheduler + paged KV + K8 (the default)
  fixed       the same steps, batch-until-drained admission
  dense       the fixed-batch full-cache loop (``make_decode_step``)

``--trace`` writes a Perfetto trace (a measured span a decode step, the
serve/* gauges as counter tracks) and ``--telemetry-jsonl`` the JSONL
stream of the step rows; check them with ``python -m
repro_torch.obs.check --engine serve --trace ... --jsonl ...``.
Generation lengths are drawn log-uniformly in [--gen-min, --gen-max].
Weights are a random init from ``--seed`` (fp32, cast once to the compute
dtype for the engines).  It prints one JSON line, with the device's name
beside ``tokens_per_s``.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer
from repro_torch.models.model import build


def make_decode_step(model, *, temperature=1.0):
    """One autoregressive decode step: the model on the last token, then a
    sample (temperature > 0: Gumbel noise from ``gen``) or the argmax.

    Returns ``step(params, tok, cache, pos, gen) -> (tok', cache, gen)``."""
    from repro_torch.serve.engine import _draw, sample

    def step(params, tok, cache, pos, gen):
        logits, cache = model.decode(params, {"tokens": tok}, cache, pos)
        lg = logits[:, -1]
        g = _draw(gen, lg.shape, temperature, lg.device)
        return sample(lg, temperature, g)[:, None], cache, gen

    return step


def draw_requests(n, prompt_len, gen_min, gen_max, vocab, seed=0):
    """Mixed-length synthetic workload: log-uniform generation budgets (the
    JAX package's numpy draws, so the same requests)."""
    from repro_torch.serve import Request
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        gen = int(round(math.exp(rng.uniform(math.log(gen_min),
                                             math.log(gen_max)))))
        prompt = tuple(rng.randint(0, vocab, prompt_len).tolist())
        reqs.append(Request(i, prompt, max(gen, 1)))
    return reqs


def run_dense(model, cfg, args, params, gen):
    """The fixed-batch full-cache loop (every request padded to the longest
    generation).  ``params`` lie on the device of ``gen``; prompts are drawn
    from ``gen``."""
    dev = gen.device
    B, P, G = args.max_slots, args.prompt_len, args.gen_max
    prompts = torch.randint(0, cfg.vocab_size, (args.requests, P),
                            generator=gen, device=dev)
    step = make_decode_step(model, temperature=args.temperature)
    total = 0
    t0 = time.perf_counter()
    for lo in range(0, args.requests, B):
        batch = prompts[lo:lo + B]
        cache = model.init_cache(batch.shape[0], P + G, dtype=torch.float32,
                                 device=dev)
        logits, cache = model.prefill(params, {"tokens": batch}, cache)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        for i in range(G - 1):
            tok, cache, gen = step(params, tok, cache, P + i, gen)
        tok.cpu()
        total += batch.shape[0] * G
    wall = time.perf_counter() - t0
    return {"engine": "dense", "tokens": total, "wall_s": round(wall, 3),
            "tokens_per_s": round(total / max(wall, 1e-9), 1)}


def device_name(dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-lm")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "fixed", "dense"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-request KV cap; 0 -> prompt-len + gen-max")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-min", type=int, default=16)
    ap.add_argument("--gen-max", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--attn", default="pallas", choices=["ref", "pallas"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu for a CPU rehearsal (default: the card)")
    ap.add_argument("--trace", default=None, metavar="OUT_JSON")
    ap.add_argument("--telemetry-jsonl", default=None, metavar="OUT_JSONL")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.embed_inputs:
        ap.error(f"{cfg.name} reads frame embeddings (its frontend is a "
                 "stub); the engines feed back the tokens they sample")
    model = build(cfg)
    gen = torch.Generator(dev).manual_seed(args.seed)
    params = transformer.cast_params(model.init(gen), cfg)

    if args.engine == "dense":
        print(json.dumps({"arch": cfg.name, **run_dense(model, cfg, args,
                                                        params, gen),
                          "device": device_name(dev)}))
        return

    from repro_torch import obs
    from repro_torch.serve import ServeConfig, ServeEngine

    telemetry = None
    if args.trace or args.telemetry_jsonl:
        sinks = [obs.JsonlSink(args.telemetry_jsonl)] \
            if args.telemetry_jsonl else []
        telemetry = obs.Telemetry(sinks=sinks, trace_path=args.trace,
                                  run_name="serve")
    max_len = args.max_len or (args.prompt_len + args.gen_max)
    scfg = ServeConfig(
        max_slots=args.max_slots, page_size=args.page_size,
        max_len=max_len, prompt_pad=max(args.prompt_len, 1),
        temperature=args.temperature, kv_int8=args.kv_int8,
        attn=args.attn)
    engine = ServeEngine(cfg, scfg, params, seed=args.seed, device=dev)
    reqs = draw_requests(args.requests, args.prompt_len, args.gen_min,
                         args.gen_max, cfg.vocab_size, seed=args.seed)
    results, stats = engine.run(reqs, telemetry=telemetry,
                                continuous=args.engine == "continuous")
    if telemetry is not None:
        telemetry.finish()
    trail = stats.pop("occupancy_trail")
    step_ms = sorted(1e3 * t for t in stats.pop("step_s"))
    admit_ms = sorted(1e3 * t for t in stats.pop("admit_s"))
    print(json.dumps({
        "arch": cfg.name, **stats,
        "requests": len(reqs),
        "kv_int8": args.kv_int8,
        "tokens_per_s": round(stats["tokens_per_s"], 1),
        "device": device_name(dev),
        "wall_s": round(stats["wall_s"], 3),
        "step_ms_median": (round(step_ms[len(step_ms) // 2], 3)
                           if step_ms else None),
        "admit_ms_median": (round(admit_ms[len(admit_ms) // 2], 3)
                            if admit_ms else None),
        "mean_occupancy": round(sum(trail) / max(len(trail), 1), 2),
        "sample_tokens": results[0][:16],
    }))


if __name__ == "__main__":
    main()
