"""The port's partition specs (``sharding/specs.py``) against the JAX
package's, leaf for leaf and exactly: ``param_specs`` (over the params and
over a whole ``PodState``: the optimizer's moments and the federation
state match by path suffix), ``param_specs_moe_ff``, ``param_specs_tp``,
``param_specs_zero1_moe``, ``cache_specs``, ``client_store_specs`` and
``client_flat_shardings``.

Every assigned architecture and tiny-lm at full width, shape only: the
port's init on the ``meta`` device (``layers.SHAPE_ONLY``), JAX's under
``jax.eval_shape``.  The meshes: the TPU pod's (16, 16) and (2, 16, 16)
with a "pod" axis, and (2, 2) and (1, 4); JAX is given each as an
``AbstractMesh``, the port a ``launch.mesh.Mesh`` of that shape.  A dim
that does not divide its axis extent is replicated in both.
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs.base import FedConfig as JFedConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import ARCHS as JARCHS
from repro.core import clientstore as jclientstore
from repro.core import pod as jpod
from repro.launch import inputs as jinputs
from repro.models import transformer as jtransformer
from repro.optim import optimizers as jopt
from repro.sharding import specs as jspecs
from repro_torch import tree
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.configs.registry import ARCHS, ASSIGNED
from repro_torch.core import clientstore, pod
from repro_torch.launch import inputs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers, transformer
from repro_torch.optim import optimizers
from repro_torch.sharding import specs

NAMES = ASSIGNED + ["tiny-lm"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
PARAM_FNS = ["param_specs", "param_specs_moe_ff", "param_specs_tp",
             "param_specs_zero1_moe"]
C = 8


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), Mesh(axes, shape, None, 0)


def _norm(spec):
    """A spec as a tuple, a one-axis tuple entry as its name (jax 0.9's
    ``PartitionSpec`` stores ("data",) as "data"; the two are one
    layout)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _jax_specs(t):
    return [_norm(s) for s in jax.tree_util.tree_leaves(
        t, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def _port_specs(t):
    out = []
    specs._walk(lambda p, s: out.append(_norm(s)), t)
    return out


@pytest.fixture(scope="module", params=NAMES)
def arch(request):
    """(name, JAX params struct, JAX PodState struct, port params on meta,
    port PodState on meta)."""
    name = request.param
    jp = jax.eval_shape(lambda: jtransformer.init_transformer(
        jax.random.PRNGKey(0), JARCHS[name]))
    j_init, _ = jopt.make_optimizer(JTrainConfig())
    js = jax.eval_shape(lambda p: jpod.init_pod_state(
        p, j_init, C, JFedConfig(n_clients=C), jax.random.PRNGKey(0)), jp)
    tp = transformer.init_transformer(layers.SHAPE_ONLY, ARCHS[name])
    t_init, _ = optimizers.make_optimizer(TrainConfig())
    ts = pod.init_pod_state(tp, t_init, C, FedConfig(n_clients=C),
                            torch.Generator())
    # the generator (JAX: a key array) is no shardable leaf
    js = js._replace(fed=js.fed._replace(rng=None))
    ts = ts._replace(fed=ts.fed._replace(rng=None))
    return name, jp, js, tp, ts


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_specs_match_jax(arch, mesh):
    _, jp, js, tp, ts = arch
    jm, tm = _meshes(mesh)
    for fn in PARAM_FNS:
        got = _port_specs(getattr(specs, fn)(tp, mesh=tm))
        want = _jax_specs(getattr(jspecs, fn)(jp, mesh=jm))
        assert got == want, fn
    # a whole PodState: the moments and the federation state by suffix
    got = _port_specs(specs.param_specs(ts, mesh=tm))
    want = _jax_specs(jspecs.param_specs(js, mesh=jm))
    assert got == want
    # and without a mesh (no divisibility guard)
    assert _port_specs(specs.param_specs(tp)) == _jax_specs(
        jspecs.param_specs(jp))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_cache_specs_match_jax(arch, mesh, shape):
    name = arch[0]
    jm, tm = _meshes(mesh)
    jc = jinputs.cache_specs_struct(JARCHS[name], shape)
    tc = inputs.cache_specs_struct(ARCHS[name], shape)
    assert [tuple(x.shape) for x in tree.leaves(tc)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jc)]
    assert _port_specs(specs.cache_specs(tc, tm)) == _jax_specs(
        jspecs.cache_specs(jc, jm))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_client_flat_shardings_match_jax(arch, mesh):
    _, jp, _, tp, _ = arch
    jm, tm = _meshes(mesh)
    sizes = [int(x.size) for x in jax.tree_util.tree_leaves(jp)]
    assert sizes == [x.numel() for x in tree.leaves(tp)]
    axes = [a for a in tm.axis_names if a != "pod"]
    for ax in (axes, axes[-1:], axes[:1]):
        got, gflags = specs.client_flat_shardings(sizes, tm, ax)
        want, wflags = jspecs.client_flat_shardings(sizes, jm, ax)
        assert gflags == wflags
        assert [_norm(g.spec) for g in got] == [_norm(w.spec) for w in want]
        assert all(g.mesh is tm for g in got)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("population", [512, 1000, 65536])
def test_client_store_specs_match_jax(mesh, population):
    jm, tm = _meshes(mesh)
    js = jax.eval_shape(lambda: jclientstore.init_store(population))
    ts = clientstore.init_store(population, device="meta")
    for axes in (("data", "model"), ("model",)):
        assert _port_specs(specs.client_store_specs(ts, tm, axes)) == \
            _jax_specs(jspecs.client_store_specs(js, jm, axes))
    # the EF residual: the port's (M, N) matrix, JAX's (M, ...) leaves,
    # split alike on the population axis
    p = {"w": torch.empty(4, 8, device="meta")}
    fed = FedConfig(compress="int8")
    ts = clientstore.init_store(population, params=p, fed_cfg=fed,
                                device="meta")
    js = jax.eval_shape(lambda: jclientstore.init_store(
        population, params={"w": jax.numpy.zeros((4, 8))},
        fed_cfg=JFedConfig(compress="int8")))
    got = specs.client_store_specs(ts, tm).ef
    want = jspecs.client_store_specs(js, jm).ef["w"]
    assert _norm(got)[0] == _norm(want)[0] and got[1:] == (None,)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_placements_follow_the_specs(mesh):
    """``placements``: Shard(d) on each mesh dim a tensor dim is split
    over (a tuple major first), Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    _, tm = _meshes(mesh)
    names = tm.axis_names
    dp = ("pod", "data") if "pod" in names else "data"
    got = specs.placements(specs.P(dp, None, "model"), tm)
    want = [Shard(2) if n == "model" else Shard(0) for n in names]
    assert got == want
    assert specs.placements(specs.P(None, None), tm) == [Replicate()] * len(
        names)
    if "pod" in names:
        with pytest.raises(ValueError, match="order"):
            specs.placements(specs.P(("data", "pod")), tm)
