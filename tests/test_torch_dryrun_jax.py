"""The port's dry-run against the reference's on the same step: tiny-lm x
train_4k (the pod step, ``robust=None``, C = 2) at a (2, 2) mesh.  The
reference lowers and compiles it for placeholder devices in a subprocess
of its own (``repro.launch.dryrun`` forces 512 host devices at import,
which must not leak into this process); the port runs it on fake tensors
over a fake (2, 2) process group.

  * the params' and the AdamW moments' per-chip bytes are exact (the
    reference's from its shardings' shard shapes);
  * ``argument_bytes`` within 0.1% of XLA's ``argument_size_in_bytes``;
  * the per-chip flops of ``_probe_costs`` within 2x of the reference's
    (counted on the local ops, not the global product: a count over the
    whole mesh would read 4x).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = r"""
import json
from repro.launch import dryrun
import jax
from jax.sharding import NamedSharding, PartitionSpec
from repro.configs.base import FedConfig, TrainConfig
from repro.configs.registry import get_config
from repro.core import pod
from repro.launch import inputs
from repro.optim import optimizers
from repro.sharding import specs as sh
mesh = jax.make_mesh((2, 2), ("data", "model"))
cfg = inputs.shape_variant(get_config("tiny-lm"), "train_4k")
lowered, params_s = dryrun.lower_train(cfg, "train_4k", mesh)
mem = lowered.compile().memory_analysis()
cost, coll = dryrun._probe_costs(cfg, "train_4k", mesh, "train")
opt_init, _ = optimizers.make_optimizer(TrainConfig(global_batch=256,
                                                    seq_len=4096))
state = jax.eval_shape(lambda p: pod.init_pod_state(
    p, opt_init, 2, FedConfig(n_clients=2), jax.random.PRNGKey(0)), params_s)
spec = sh.param_specs(state, mesh=mesh)


def local_bytes(t, s):
    specs = jax.tree_util.tree_leaves(
        s, is_leaf=lambda x: isinstance(x, PartitionSpec))
    n = 0
    for leaf, p in zip(jax.tree_util.tree_leaves(t), specs):
        k = 1
        for d in NamedSharding(mesh, p).shard_shape(leaf.shape):
            k *= d
        n += k * leaf.dtype.itemsize
    return n


print(json.dumps({"argument_bytes": mem.argument_size_in_bytes,
                  "flops": cost["flops"],
                  "params_bytes": local_bytes(state.params, spec.params),
                  "opt_bytes": local_bytes(state.opt_state,
                                           spec.opt_state)}))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    from repro_torch import tree
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun, inputs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.sharding import dtensor
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = inputs.shape_variant(get_config("tiny-lm"), "train_4k")
    try:
        with mesh_mod.fake_group(4):
            mesh = mesh_mod.make_grid_mesh((2, 2), ("data", "model"))
            low, params_s = dryrun.lower_train(cfg, "train_4k", mesh)
            cost, _ = dryrun._probe_costs(cfg, "train_4k", mesh, "train")
            with dryrun._fake_mode():
                state, _, _ = dryrun.train_setup(
                    cfg, "train_4k", mesh, dryrun._fake_like(params_s))
                local = lambda t: sum(
                    dtensor.local(x).numel() * dtensor.local(x).element_size()
                    for x in tree.leaves(t) if isinstance(x, torch.Tensor))
                out = {"argument_bytes": low.memory["argument_bytes"],
                       "flops": cost["flops"],
                       "params_bytes": local(state.params),
                       "opt_bytes": local(state.opt_state)}
    finally:
        torch.set_num_threads(n)
    return out


def test_state_bytes_per_chip_exact(reference, port):
    assert port["params_bytes"] == reference["params_bytes"]
    assert port["opt_bytes"] == reference["opt_bytes"]


def test_argument_bytes_match_xla(reference, port):
    assert abs(port["argument_bytes"] / reference["argument_bytes"] - 1) \
        < 1e-3


def test_per_chip_flops_within_2x_of_xla(reference, port):
    ratio = port["flops"] / reference["flops"]
    print(f"port / XLA per-chip flops: {ratio:.4f}")
    assert 0.5 <= ratio <= 2.0
