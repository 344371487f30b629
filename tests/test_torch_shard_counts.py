"""The port's sharded step counted per chip against the reference's, at
small widths: the port's dry-run (``repro_torch.launch.dryrun``: fake
tensors over a fake process group, ``roofline.CostCounter``) beside the
reference's (``repro.launch.dryrun``: XLA's cost analysis and collectives
of the compiled step, composed from unrolled probes as its ``run_one``
does), which lowers in one subprocess of its own (it forces 512 host
devices at import, which must not leak into this process).

  * the MoE step (granite at small widths, its own capacity factor, 2 x
    2): all-gather at most 2x the reference's, all collective bytes at
    most 2x, flops at most 1.2x;
  * head counts that do not split over "model" (6 q / 2 kv heads on 1 x
    4, as qwen2.5-14b's 40 / 8 on 16): flops at most 1.25x the
    reference's, all collective bytes at most 1.25x;
  * a decode step on a cache split on its sequence over "model" (6 / 2
    heads on 1 x 4): no collective grows with the cache (the same bytes of
    each kind at two cache lengths);
  * the per-client reshard (tiny-lm at small widths, C = 4, W = 2): the
    port's all-to-all moves each client's row once, (C/W) x N fp32 a
    rank, and is recorded beside the reference's all-to-all in the same
    step.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

# name, arch, its small-width changes, shape (name, seq, batch, kind), mesh
CASES = [
    ("moe", "granite-moe-1b-a400m", {"capacity_factor": 1.25},
     ("t", 64, 8, "train"), (2, 2)),
    ("uneven", "qwen2.5-14b",
     {"n_heads": 6, "n_kv_heads": 2, "head_dim": 32, "d_model": 192},
     ("t", 64, 8, "train"), (1, 4)),
    ("decode", "minitron-4b",
     {"n_heads": 6, "n_kv_heads": 2, "head_dim": 32, "d_model": 192,
      "dtype": "bfloat16"}, ("d", 256, 4, "decode"), (1, 4)),
]
CLIENTS, W = 4, 2                       # the per-client step
MOE_AG, MOE_TOTAL, MOE_FLOPS = 2.0, 2.0, 1.2
UNEVEN_FLOPS, UNEVEN_TOTAL = 1.25, 1.25

_REFERENCE = r"""
import json
import sys
from repro.launch import dryrun
import jax
from repro.configs import base
from repro.configs.base import FedConfig, TrainConfig
from repro.configs.registry import get_config
from repro.core import pod
from repro.launch import inputs
from repro.launch import roofline as roof
from repro.models import transformer
from repro.optim import optimizers
from repro.sharding import specs as sh
cases, C, W = json.loads(sys.argv[1])
auto = (jax.sharding.AxisType.Auto,) * 2
out = {}
for name, arch, kw, shape, mesh in cases:
    base.INPUT_SHAPES[shape[0]] = base.InputShape(*shape)
    cfg = get_config(arch).reduced().replace(**kw)
    m = jax.make_mesh(tuple(mesh), ("data", "model"), axis_types=auto)
    cost, coll = dryrun._probe_costs(cfg, shape[0], m, shape[3])
    out[name] = {"flops": cost["flops"], "collectives": coll}
# the per-client step (robust='per_client', aggregated over the mesh)
base.INPUT_SHAPES["t"] = base.InputShape("t", 64, 8, "train")
cfg = get_config("tiny-lm").reduced()
m = jax.make_mesh((W, 1), ("data", "model"), axis_types=auto)
fed = FedConfig(n_clients=C)
tc = TrainConfig(global_batch=8, seq_len=64)
params_s = jax.eval_shape(lambda k: transformer.init_transformer(k, cfg),
                          jax.random.PRNGKey(0))
opt_init, _ = optimizers.make_optimizer(tc)
state_s = jax.eval_shape(lambda p: pod.init_pod_state(
    p, opt_init, C, fed, jax.random.PRNGKey(0)), params_s)
batch_s = inputs.train_batch_specs(cfg, "t")
step = pod.make_train_step(cfg, fed, tc, robust="per_client", agg_mesh=m)
with m:
    low = jax.jit(step, in_shardings=(
        dryrun._named(m, sh.param_specs(state_s, mesh=m)),
        dryrun._named(m, sh.batch_specs(batch_s, m))),
        out_shardings=(dryrun._named(m, sh.param_specs(state_s, mesh=m)),
                       None)).lower(state_s, batch_s)
out["per_client"] = {"collectives": roof.parse_collectives(
    low.compile().as_text())}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE,
                          json.dumps([CASES, CLIENTS, W])], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _count(name, arch, kw, shape, mesh):
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    cfg = get_config(arch).reduced().replace(**kw)
    with mesh_mod.fake_group(mesh[0] * mesh[1]):
        m = mesh_mod.make_grid_mesh(tuple(mesh), ("data", "model"))
        low, _ = dryrun._lower_for(cfg, InputShape(*shape), m, shape[3])
    return {"flops": low.cost["flops"], "collectives": low.collectives}


@pytest.fixture(scope="module")
def port():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {c[0]: _count(*c) for c in CASES}
        # the decode step again at twice the cache length
        name, arch, kw, (s, T, B, kind), mesh = CASES[2]
        out["decode_2T"] = _count(name, arch, kw, (s, 2 * T, B, kind), mesh)
        out["per_client"] = _per_client()
    finally:
        torch.set_num_threads(n)
    return out


def _per_client():
    """The port's per-client step at W = 2 on real small tensors over a
    fake group (the aggregation's kernel wrappers take no fake tensor):
    its collectives and the params' count."""
    from repro_torch import tree
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer
    cfg = get_config("tiny-lm").reduced()
    params = transformer.init_transformer(torch.Generator().manual_seed(0),
                                          cfg)
    with mesh_mod.fake_group(W):
        m = mesh_mod.make_grid_mesh((W, 1), ("data", "model"))
        state, batch, step = dryrun.train_setup(
            cfg, InputShape("t", 64, 8, "train"), m, params,
            n_clients=CLIENTS, robust="per_client")
        _, low = dryrun._count(step, state, batch)
    return {"collectives": low.collectives,
            "n_params": sum(x.numel() for x in tree.leaves(params))}


def _total(rec):
    return sum(rec["collectives"].values())


def test_moe_step_moves_and_computes_what_the_reference_does(reference,
                                                              port):
    got, ref = port["moe"], reference["moe"]
    ag = got["collectives"]["all-gather"] / ref["collectives"]["all-gather"]
    total = _total(got) / _total(ref)
    flops = got["flops"] / ref["flops"]
    print(f"MoE 2 x 2, port / XLA: all-gather {ag:.3f}, collective bytes "
          f"{total:.3f}, flops {flops:.3f}")
    assert ag <= MOE_AG
    assert total <= MOE_TOTAL
    assert flops <= MOE_FLOPS


def test_uneven_heads_compute_what_the_reference_does(reference, port):
    got, ref = port["uneven"], reference["uneven"]
    flops = got["flops"] / ref["flops"]
    total = _total(got) / _total(ref)
    print(f"6 / 2 heads on 1 x 4, port / XLA: flops {flops:.3f}, "
          f"collective bytes {total:.3f}")
    assert flops <= UNEVEN_FLOPS
    assert total <= UNEVEN_TOTAL


def test_decode_collectives_do_not_grow_with_the_cache(reference, port):
    one, two = port["decode"], port["decode_2T"]
    # a gathered cache would add (M - 1) / M of it a layer at each length
    assert one["collectives"] == two["collectives"]
    print(f"decode 1 x 4: port {one['collectives']}, XLA "
          f"{reference['decode']['collectives']}")


def test_per_client_reshard_moves_each_row_once(reference, port):
    got = port["per_client"]
    a2a = got["collectives"]["all-to-all"]
    # (W, C/W, N/W) fp32 out of each rank: C/W client rows of N columns
    assert a2a == CLIENTS // W * got["n_params"] * 4
    ref = reference["per_client"]["collectives"]["all-to-all"]
    assert ref > 0
    print(f"per-client step, W = {W}, C = {CLIENTS}: all-to-all port {a2a} "
          f"B, XLA {ref:.0f} B a chip")
