"""The port's ZeRO-1 pod step (``make_train_step(zero1_shardings=)``: a bf16
compute copy whole over "data", the grads cast to fp32 and brought to the
master layout) against the JAX package's ZeRO-1 step, on a (1, 1) mesh.

The reference's own ``test_zero1_matches_baseline_loss`` fails on this
install: jax 0.9's ``jax.make_mesh`` builds Explicit axes, which
``with_sharding_constraint`` refuses.  Its step is run here on a mesh
built with ``AxisType.Auto`` axes (the JAX package is not edited).

  * the tiny-lm step (``param_specs_tp`` compute, ``param_specs`` master)
    and the MoE step of granite-moe-1b-a400m.reduced()
    (``param_specs_zero1_moe`` compute, ``param_specs_moe_ff`` master),
    from JAX's init and the same batch: loss and grad_norm within 1e-2
    relative (the compute is bf16, rounded in other orders);
  * each against the port's fp32 step: loss within 0.05 (the reference
    test's tolerance);
  * the state placed by the master layout or left whole: the same step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import ARCHS as JARCHS
from repro.core import pod as jpod
from repro.models import transformer as jtransformer
from repro.optim import optimizers as jopt
from repro.sharding import specs as jspecs
from repro_torch import interop
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.core import pod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim import optimizers
from repro_torch.sharding import specs

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=128, head_dim=16)
C, B, S = 2, 4, 16
REL = 1e-2
KEY = jax.random.PRNGKey(0)
LAYOUTS = {   # name -> (arch, compute specs, master specs) per package
    "tp": ("tiny-lm", "param_specs_tp", "param_specs"),
    "zero1_moe": ("granite-moe-1b-a400m", "param_specs_zero1_moe",
                  "param_specs_moe_ff"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    jc, tc = JARCHS[arch], ARCHS[arch]
    if arch != "tiny-lm":
        jc, tc = jc.reduced(), tc.reduced()
    return jc.replace(**SMALL), tc.replace(**SMALL)


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def case(request):
    arch, comp, mast = LAYOUTS[request.param]
    jc, tc = _cfgs(arch)
    jp = jtransformer.init_transformer(KEY, jc)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    batch = {"tokens": np.asarray(jax.random.randint(k1, (B, S), 0, 128)),
             "targets": np.asarray(jax.random.randint(k2, (B, S), 0, 128))}
    jfed, jtc = JFedConfig(n_clients=C), JTrainConfig(
        global_batch=B, seq_len=S, total_steps=4, warmup_steps=1)
    j_init, _ = jopt.make_optimizer(jtc)
    js = jpod.init_pod_state(jp, j_init, C, jfed, KEY)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    shs = tuple(jspecs.named(jmesh, getattr(jspecs, f)(jp, mesh=jmesh))
                for f in (comp, mast))
    step = jax.jit(jpod.make_train_step(jc, jfed, jtc, zero1_shardings=shs))
    with jmesh:
        _, jm = step(js, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = {k: float(v) for k, v in jm.items()}
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return tc, comp, mast, np_params, batch, ref


def _port(tc, np_params, batch, *, zero1=None, placed=False):
    fed = FedConfig(n_clients=C)
    ttc = TrainConfig(global_batch=B, seq_len=S, total_steps=4,
                      warmup_steps=1)
    opt_init, _ = optimizers.make_optimizer(ttc)
    params = interop.params_from_numpy(np_params)
    with mesh_mod.host_mesh(device="cpu") as mesh:
        shs = None
        if zero1 is not None:
            shs = tuple(specs.named(mesh, getattr(specs, f)(params,
                                                            mesh=mesh))
                        for f in zero1)
        master = None
        if placed:      # the whole state by the master layout
            fn = getattr(specs, zero1[1] if zero1 else "param_specs")
            master = lambda st: specs.named(mesh, fn(st, mesh=mesh))
        state = pod.init_pod_state(params, opt_init, C, fed,
                                   torch.Generator().manual_seed(0),
                                   shardings=master)
        step = pod.make_train_step(tc, fed, ttc, zero1_shardings=shs)
        tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        state, m = step(state, tb)
        return {k: float(v) for k, v in m.items()}, state


@pytest.mark.parametrize("placed", [False, True])
def test_zero1_matches_the_reference_zero1(case, placed):
    tc, comp, mast, np_params, batch, ref = case
    got, state = _port(tc, np_params, batch, zero1=(comp, mast),
                       placed=placed)
    for k in ("loss", "grad_norm"):
        assert abs(got[k] - ref[k]) <= REL * abs(ref[k]), (k, got[k], ref[k])
    assert np.isfinite(got["grad_norm"])
    # the master state stays fp32 and, placed, a DTensor in its layout
    leaf = state.params["layers"]["b0"]["attn"]["wq"]
    assert leaf.dtype == torch.float32
    from repro_torch.sharding import dtensor
    assert dtensor.is_dtensor(leaf) == placed


def test_zero1_loss_near_the_fp32_step(case):
    tc, comp, mast, np_params, batch, _ = case
    z1, _ = _port(tc, np_params, batch, zero1=(comp, mast))
    base, _ = _port(tc, np_params, batch)
    assert abs(z1["loss"] - base["loss"]) < 0.05
