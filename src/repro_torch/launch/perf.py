"""Perf-iteration driver (port of ``repro/launch/perf.py``): the roofline
terms of optimisation variants of the three hillclimbed (arch x shape)
pairs at 16 x 16, from the dry-run's probes only (``dryrun._probe_costs``
on a fake process group: counted per chip, nothing measured).  The probes
(``dryrun.PROBE_DEPTHS``: 2 and 4 layers of each block kind) save the
full-depth run.  Their composition equals the full-depth count for the
pairs' attn, moe and hybrid stacks, on torch 2.13 and on the card
machine's torch 2.11 alike.  It is not exact for an xLSTM stack, whose
layers cost differently by their place in it: at small widths its train
step composes within 5% in flops and bytes and within 15% in each
collective kind (``tests/test_torch_dryrun.py``; ROADMAP §3); no pair here
has xLSTM blocks, and ``dryrun.run_one`` gives the exact full-depth
count.

  PYTHONPATH=src python -m repro_torch.launch.perf --pair qwen --variant zero1
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch import inputs as inputs_lib
from repro_torch.launch import roofline as roof
from repro_torch.launch.dryrun import _probe_costs
from repro_torch.launch.mesh import fake_group, make_production_mesh

PAIRS = {
    "qwen": ("qwen2.5-14b", "train_4k"),
    "dbrx": ("dbrx-132b", "train_4k"),
    "hymba": ("hymba-1.5b", "train_4k"),
}

# variant name -> (cfg override dict, lowering variant)
VARIANTS = {
    "baseline": ({}, "baseline"),
    "zero1": ({}, "zero1"),
    "moe_ff": ({}, "moe_ff"),
    "moe_ff_cap1": ({"capacity_factor": 1.0}, "moe_ff"),
    "zero1_moe": ({}, "zero1_moe"),
    "zero1_cap1": ({"capacity_factor": 1.0}, "zero1"),
    "noremat": ({"remat": False}, "baseline"),
    "zero1_noremat": ({"remat": False}, "zero1"),
    "bf16scan": ({"ssm_scan_dtype": "bfloat16"}, "baseline"),
    "zero1_bf16scan": ({"ssm_scan_dtype": "bfloat16"}, "zero1"),
    "zero1_bf16scan_noremat": (
        {"ssm_scan_dtype": "bfloat16", "remat": False}, "zero1"),
    "chunk512": ({"scan_chunk": 512}, "baseline"),
}


def measure(pair, variant_name, json_path=None):
    """The variant's composed per-chip costs and roofline terms, over a
    fake 256-rank group this function starts (and destroys)."""
    arch, shape_name = PAIRS[pair]
    overrides, lower_variant = VARIANTS[variant_name]
    cfg = inputs_lib.shape_variant(get_config(arch), shape_name)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = INPUT_SHAPES[shape_name]
    with fake_group(256):
        mesh = make_production_mesh()
        cost, coll = _probe_costs(cfg, shape_name, mesh, shape.kind,
                                  lower_variant)
    terms = roof.roofline(cost, coll)
    res = {"pair": pair, "arch": arch, "shape": shape_name,
           "variant": variant_name, **terms}
    print(json.dumps(res, indent=1, default=float))
    if json_path:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "a") as f:
            f.write(json.dumps(res, default=float) + "\n")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", required=True, choices=list(PAIRS))
    ap.add_argument("--variant", required=True, choices=list(VARIANTS))
    ap.add_argument("--json", default="results/perf_iters.jsonl")
    args = ap.parse_args(argv)
    measure(args.pair, args.variant, args.json)


if __name__ == "__main__":
    main()
