"""``repro_torch/launch/roofline.py`` against the JAX package's
``repro/launch/roofline.py``, and its per-chip cost counter.

  * ``count_params``, ``active_params`` and ``model_flops`` equal the
    reference's for every ``ARCHS`` entry and every input-shape kind (the
    port's init on ``layers.SHAPE_ONLY`` against ``jax.eval_shape``);
  * ``roofline`` gives the reference's dict, with the reference module's
    constants set to the port's H100 ones (the JAX file is not edited);
  * ``measured_wire_bytes`` gives the reference's result on the same rows
    and on the same JSONL file;
  * ``CostCounter`` on one DTensor matmul over a fake 16 x 16 group counts
    this rank's work, worked out by hand: the local forward product
    2 * 256 * 8192 * 512 flops (and its two backward products), the
    all-gather of the weight's FSDP leg (8192 x 512 fp32 out) and the
    reduce-scatter of its grad (512 x 512 fp32 out); the same on a second
    call with the same shapes, when DTensor's shape propagation is cached;
    DTensor's methods are its own again once the counter exits.
"""
import json

import pytest
import torch

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import roofline as roof


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_params(cfg):
    from repro_torch.models import small, transformer
    from repro_torch.models.layers import SHAPE_ONLY
    if cfg.arch_type == "cnn":
        return small.init_cnn(torch.Generator(), cfg)
    if cfg.arch_type == "mlp":
        return small.init_mlp_clf(torch.Generator(), cfg)
    return transformer.init_transformer(SHAPE_ONLY, cfg)


def _jax_params(name):
    import jax
    from repro.configs.registry import ARCHS as JARCHS
    from repro.models.model import build
    return jax.eval_shape(lambda k: build(JARCHS[name]).init(k),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_counts_and_model_flops_match_reference(name):
    from repro.configs.base import INPUT_SHAPES as JSHAPES
    from repro.configs.registry import ARCHS as JARCHS
    from repro.launch import roofline as jroof
    cfg, jcfg = ARCHS[name], JARCHS[name]
    n = roof.count_params(_port_params(cfg))
    assert n == jroof.count_params(_jax_params(name))
    assert roof.active_params(cfg, n) == jroof.active_params(jcfg, n)
    for shape_name, shape in INPUT_SHAPES.items():
        assert roof.model_flops(cfg, n, shape, shape.kind) == \
            jroof.model_flops(jcfg, n, JSHAPES[shape_name], shape.kind)


def test_roofline_matches_reference_on_the_port_constants(monkeypatch):
    from repro.launch import roofline as jroof
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(jroof, name, getattr(roof, name))
    cases = [
        ({"flops": 8.7e14, "bytes accessed": 1.3e14},
         {"all-gather": 9.0e11, "all-reduce": 7.3e12, "reduce-scatter": 0,
          "all-to-all": 6.0e11, "collective-permute": 1.1e11}),
        ({"flops": 3.0e15, "bytes accessed": 1.0e9},
         {k: 0 for k in roof.COLLECTIVES}),
        ({"flops": 0.0, "bytes accessed": 5.0e12},
         {"all-reduce": 1.0e9}),
    ]
    for cost, coll in cases:
        assert roof.roofline(cost, coll) == jroof.roofline(cost, coll)
    # the H100's constants, not a TPU's
    assert (roof.PEAK_FLOPS_BF16, roof.HBM_BW, roof.ICI_BW) == (
        989e12, 3.35e12, 450e9)


def test_measured_wire_bytes_matches_reference(tmp_path):
    from repro.launch import roofline as jroof
    rows = [{"obs/wire/bytes_up": 100.0 * i, "obs/wire/bytes_down": 7.0 * i}
            for i in range(1, 5)] + [{"obs/wire/bytes_up": 3.0}, {"x": 1}]
    assert roof.measured_wire_bytes(rows) == jroof.measured_wire_bytes(rows)
    assert roof.measured_wire_bytes([]) == jroof.measured_wire_bytes([])
    path = tmp_path / "t.jsonl"
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps({"kind": "metrics", **r}) + "\n")
        f.write(json.dumps({"kind": "span", "obs/wire/bytes_up": 9e9}) + "\n")
        f.write("\n")
    assert roof.measured_wire_bytes(str(path)) == \
        jroof.measured_wire_bytes(str(path))


def test_counter_counts_one_ranks_dtensor_matmul_at_16x16():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    from repro_torch.launch import mesh as mesh_mod
    own = (ShardingPropagator._propagate_tensor_meta_non_cached,
           _StridedShard.local_shard_size_and_offset)
    with mesh_mod.fake_group(256):
        dm = mesh_mod.make_production_mesh().device_mesh
        with FakeTensorMode():
            x = distribute_tensor(torch.zeros(4096, 8192), dm,
                                  [Shard(0), Replicate()],
                                  src_data_rank=None).requires_grad_()
            w = distribute_tensor(torch.zeros(8192, 8192), dm,
                                  [Shard(0), Shard(1)],
                                  src_data_rank=None).requires_grad_()
            g = distribute_tensor(torch.zeros(4096, 8192), dm,
                                  [Shard(0), Shard(1)], src_data_rank=None)
            counts = []
            for _ in range(2):
                c = roof.CostCounter()
                with c:
                    assert ShardingPropagator.\
                        _propagate_tensor_meta_non_cached is not own[0]
                    wg = w.redistribute(dm, [Replicate(), Shard(1)])
                    y = x @ wg
                    fwd = c.flops
                    y.backward(g)
                # DTensor's own methods again once the counter exits
                assert (ShardingPropagator._propagate_tensor_meta_non_cached,
                        _StridedShard.local_shard_size_and_offset) == own
                x.grad = w.grad = None
                counts.append((fwd, c.costs()))
    fwd_flops = 2 * 256 * 8192 * 512
    for fwd, (cost, coll) in counts:
        assert fwd == fwd_flops
        # dX = dY Wg^T (256 x 512 @ 512 x 8192), dWg = X^T dY
        assert cost["flops"] == 3 * fwd_flops
        assert coll == {"all-gather": 8192 * 512 * 4, "all-reduce": 0,
                        "reduce-scatter": 512 * 512 * 4, "all-to-all": 0,
                        "collective-permute": 0}
    assert counts[0] == counts[1]
    assert counts[0][1][0]["bytes accessed"] > 0


def test_counter_tracks_live_storage():
    c = roof.CostCounter()
    a = torch.zeros(1000)
    assert c.track({"a": a}) == 4000
    with c:
        b = a + 1                       # reads 4000, writes 4000: live 8000
        del b                           # freed: 4000
        d = torch.cat([a, a])           # reads 8000, writes 8000
        v = d.view(2, 1000)             # a view: no bytes, no storage
    assert c.peak_bytes == 4000 + 8000
    assert c.live == 4000 + 8000
    assert c.bytes == 2 * 4000 + 2 * 8000 and c.flops == 0
    del d, v
    assert c.live == 4000
