"""The port's dry-run (``repro_torch/launch/dryrun.py``, ``perf.py``): the
sharded step run on fake tensors over a fake process group, counted per
chip.

  * ``_probe_costs`` (the reference's composition from one- and two-layer
    probes of each block kind) equals the full-depth count of flops,
    bytes and each collective kind, for three-layer stacks of attn, moe,
    hybrid and xattn blocks (``remat`` on) in train, prefill and decode,
    at small widths on a fake (2, 2) group; for the xLSTM stack (mLSTM,
    sLSTM, mLSTM) in prefill and decode, and in train its flops and bytes
    within 5% and each collective kind within 15% (there its layers'
    costs depend on their place in the stack: flops compose 0.55% low,
    reduce-scatter bytes 12.9% low, ROADMAP §3).  ``perf.measure`` alone
    uses the composition; ``run_one`` reports the full-depth count;
  * the fake-group context refuses to start where a group exists and
    leaves none behind, and a kernel wrapper reached by a fake tensor
    raises;
  * ``perf.measure("qwen", "baseline")`` runs at full width on 16 x 16;
  * ``PAIRS`` and ``VARIANTS`` equal the reference's (read from its
    source: importing ``repro.launch.perf`` would force 512 host devices
    on this process's JAX).
"""
import ast
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun, perf
from repro_torch.launch import mesh as mesh_mod

ROOT = Path(__file__).resolve().parents[1]
_XL = get_config("xlstm-350m").reduced()
STACKS = {
    "attn": get_config("qwen2.5-14b").reduced().replace(n_layers=3),
    "moe": get_config("granite-moe-1b-a400m").reduced().replace(n_layers=3),
    "hybrid": get_config("hymba-1.5b").reduced().replace(n_layers=3),
    "xattn": get_config("llama-3.2-vision-90b").reduced().replace(
        n_layers=3, block_pattern=("xattn",) * 3),
    "xlstm": _XL.replace(n_layers=3, block_pattern=("mlstm", "slstm",
                                                    "mlstm")),
}
SHAPES = {"train": InputShape("t", 64, 8, "train"),
          "prefill": InputShape("p", 64, 4, "prefill"),
          "decode": InputShape("d", 64, 4, "decode")}
XLSTM_TRAIN_REL, XLSTM_TRAIN_COLL_REL = 0.05, 0.15


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mesh22():
    with mesh_mod.fake_group(4):
        yield mesh_mod.make_grid_mesh((2, 2), ("data", "model"))


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_probe_composition_equals_full_depth_count(mesh22, stack, kind):
    cfg = STACKS[stack].replace(remat=True, loss_chunk=32)
    full, _ = dryrun._lower_for(cfg, SHAPES[kind], mesh22, kind)
    cost, coll = dryrun._probe_costs(cfg, SHAPES[kind], mesh22, kind)
    assert set(coll) == set(full.collectives)
    if stack == "xlstm" and kind == "train":
        for k in ("flops", "bytes accessed"):
            assert abs(cost[k] - full.cost[k]) <= XLSTM_TRAIN_REL * \
                full.cost[k], k
        for k, n in full.collectives.items():
            assert abs(coll[k] - n) <= XLSTM_TRAIN_COLL_REL * n, k
        return
    assert cost == full.cost
    assert coll == full.collectives


def test_fake_group_refuses_an_existing_group_and_leaves_none(tmp_path):
    assert not dist.is_initialized()
    with mesh_mod.fake_group(8):
        assert dist.get_backend() == "fake" and dist.get_world_size() == 8
        with pytest.raises(RuntimeError, match="exists"):
            with mesh_mod.fake_group(8):
                pass
        with pytest.raises(ValueError, match="does not span"):
            mesh_mod.make_grid_mesh((2, 2), ("data", "model"))
    assert not dist.is_initialized()
    with mesh_mod.host_mesh(device="cpu"):      # a real (gloo) group
        with pytest.raises(RuntimeError, match="exists"):
            with mesh_mod.fake_group(256):
                pass
        with pytest.raises(RuntimeError, match="fake default group"):
            mesh_mod.make_production_mesh()
    assert not dist.is_initialized()


def test_kernel_wrapper_on_a_fake_tensor_raises():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import flash_attention, robust_agg
    from repro_torch.kernels import robust_pipeline as rp
    before = dict(robust_agg.robust_agg_fwd.launches)
    with FakeTensorMode():
        x = torch.zeros(4, 256)
        with pytest.raises(RuntimeError, match="fake tensor"):
            robust_agg.robust_agg_fwd(x, torch.ones(4), mode="median")
        with pytest.raises(RuntimeError, match="fake tensor"):
            rp.cosine_gate_partials(x[None], torch.ones(1, 4))
        q = torch.zeros(1, 2, 128, 16)
        with torch.no_grad(), pytest.raises(RuntimeError,
                                            match="fake tensor"):
            flash_attention.flash_attention_fwd(q, q, q)
    assert robust_agg.robust_agg_fwd.launches == before


def test_perf_measure_qwen_baseline_full_width():
    res = perf.measure("qwen", "baseline")
    assert not dist.is_initialized()
    assert res["arch"] == "qwen2.5-14b" and res["shape"] == "train_4k"
    for k in ("compute_s", "memory_s", "collective_s", "hlo_flops",
              "hlo_bytes", "collective_bytes", "collective_by_kind",
              "dominant", "bound_s"):
        assert k in res
    assert res["hlo_flops"] > 0 and res["collective_bytes"] > 0
    assert res["bound_s"] == max(res["compute_s"], res["memory_s"],
                                 res["collective_s"])


def _reference_dict(name):
    src = (ROOT / "src" / "repro" / "launch" / "perf.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == name:
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_pairs_and_variants_equal_reference():
    assert perf.PAIRS == _reference_dict("PAIRS")
    assert perf.VARIANTS == _reference_dict("VARIANTS")
