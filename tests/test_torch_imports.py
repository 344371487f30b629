"""The port stands alone and runs on the card unless asked otherwise:
no repro_torch module (nor chip_smoke.py) imports jax or anything of the
JAX package or starts a process group when imported, the entry points
raise without CUDA, and chip_smoke.py prints no result and exits non-zero
without CUDA or outside the repo."""
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
chip_smoke.bound(1, 1); chip_smoke.kernel_work("pairwise_gram", 1, 2, 3)
import torch.distributed as dist
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
# no module starts a process group (the dry-run's fake one included) when
# it is imported
print(len(names), bad, dist.is_initialized(), all(m in names for m in (
    "repro_torch.scenarios", "repro_torch.scenarios.engine",
    "repro_torch.scenarios.registry", "repro_torch.core.attacks",
    "repro_torch.kernels.robust_agg_ops", "repro_torch.serve",
    "repro_torch.serve.engine", "repro_torch.serve.scheduler",
    "repro_torch.launch.serve", "repro_torch.kernels.paged_decode",
    "repro_torch.kernels.paged_decode_ref",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.flash_attention_ops",
    "repro_torch.kernels.flash_attention_ref",
    "repro_torch.models.transformer", "repro_torch.configs.registry",
    "repro_torch.core.driver", "repro_torch.kernels.launches",
    "repro_torch.obs", "repro_torch.obs.counters", "repro_torch.obs.sinks",
    "repro_torch.obs.monitors", "repro_torch.obs.trace",
    "repro_torch.obs.check", "repro_torch.core.pod",
    "repro_torch.optim.optimizers", "repro_torch.checkpoint.checkpoint",
    "repro_torch.sharding.specs", "repro_torch.sharding.collectives",
    "repro_torch.launch.mesh", "repro_torch.launch.inputs",
    "repro_torch.launch.train", "repro_torch.models.moe",
    "repro_torch.models.ssm", "repro_torch.models.xlstm",
    "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
    "repro_torch.launch.perf", "repro_torch.analysis",
    "repro_torch.analysis.report", "repro_torch.analysis.traversal",
    "repro_torch.analysis.rules", "repro_torch.analysis.entrypoints",
    "repro_torch.analysis.lint")))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return env


def test_port_imports_no_jax_and_no_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE], env=_env(),
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert int(out[0]) >= 20, out            # every module was imported
    # no jax, no group started, and the scenarios, serving, K8/K9, the
    # dry-run and its roofline among the modules
    assert out[1:] == ["[]", "False", "True"], out


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.paper_models import MLP_CONFIG
    from repro_torch.core import fedfits
    from repro_torch.data.pipeline import build_federation
    from repro_torch.models.model import build
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fedfits.run(build(MLP_CONFIG), FedConfig(n_clients=2),
                    lambda t, g: None, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_federation(0, n=40, n_clients=2)
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = get_config("tiny-lm").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, ServeConfig(), build(cfg).init(torch.Generator()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "tiny-lm", "--reduced"])
    from repro_torch.launch import train as launch_train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "tiny-lm", "--reduced", "--steps", "1",
                           "--robust", "per_client"])
    from repro_torch.analysis import lint
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lint.main(["--all"])


def test_unported_options_raise():
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.paper_models import MLP_CONFIG
    from repro_torch.core import async_engine, driver, fedfits
    from repro_torch.models.model import build
    model = build(MLP_CONFIG)
    for kw in [dict(agg_blk=512)]:
        with pytest.raises(NotImplementedError):
            fedfits.make_round(model, FedConfig(**kw))
    cfg = FedConfig(n_clients=2, population=8)
    pop = {"x": torch.zeros(8, 3, 22), "y": torch.zeros(8, 3),
           "eval_x": torch.zeros(8, 2, 22), "eval_y": torch.zeros(8, 2),
           "n": torch.ones(8)}
    body = lambda st, xs: (st, {})
    # no entry point names item e or item g any more: telemetry and the pod
    # path are ported, its model axis and ZeRO-1 too (item g' named them)
    src = ROOT / "src" / "repro_torch"
    assert not [p for p in src.rglob("*.py") if "item e" in p.read_text()
                or re.search(r"item g\b", p.read_text())]
    # nor item 13: every block kind is ported
    assert not [p for p in src.rglob("*.py") if "item 13" in p.read_text()]
    # the driver stages a rank's rows of each batch: rank 1 of 2 here
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.sharding.specs import NamedSharding, P
    mesh = Mesh(("data", "model"), (2, 1), None, 1)
    sh = {"x": NamedSharding(mesh, P(("data",), None))}
    _, stacked = driver.stage_chunk(
        lambda t: {"x": torch.arange(8.0).reshape(4, 2) + t}, [0, 1],
        batch_sharding=driver.chunk_sharding(sh))
    assert stacked["x"].tolist() == [[[4.0, 5.0], [6.0, 7.0]],
                                     [[5.0, 6.0], [7.0, 8.0]]]
    assert driver.ScanDriver(body, batch_sharding=sh).put_sharding == \
        driver.chunk_sharding(sh)
    # a model axis: a 1 x 2 mesh over a gloo group of one clamps to 1 x 1,
    # as jax.make_mesh's host mesh clamps to the device count
    from repro_torch.launch.mesh import host_mesh
    with host_mesh(device="cpu"):
        m = make_host_mesh(1, 2)
        assert m.shape == (1, 1) and m.device_mesh is not None
        assert m.device_mesh.mesh_dim_names == ("data", "model")
        assert m.over(("model",)).size == 1
    with pytest.raises(ValueError, match="dense-uplink"):
        async_engine.make_async_round(
            model, dataclasses.replace(cfg, population=0, compress="int8"),
            pop)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda_or_repo(alone, tmp_path):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is available")
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        cwd = tmp_path
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_names_the_register_bodies_in_ptxas_report():
    """``chip_smoke.py`` phase 1 turns nvcc's -Xptxas -v output into one
    line a register body: K8 by row block, vector, vectors a lane and
    pool; the combine's rank network by bucket, columns a thread and
    whether C fills the bucket; pass 1's by bucket, columns a thread and
    loads, and its shared tile by row source; K7's one body by name;
    registers and spills as ptxas printed them."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    entries = {
        "_ZN12_GLOBAL__N_19pd_kernelILi3ELi4ELi1EfLb0EEEvPKvPKT2_": (96, 0),
        "_ZN12_GLOBAL__N_19pd_kernelILi8ELi4ELi1EaLb1EEEvPKvPKT2_": (128, 0),
        "_ZN12_GLOBAL__N_113combine_ranksINS_9DenseRowsELi16ELi2ELb1EEEvT_":
            (79, 0),
        "_ZN12_GLOBAL__N_113combine_ranksINS_9QuantRowsELi64ELi1ELb0EEEvT_":
            (255, 12),
        "_ZN12_GLOBAL__N_112combine_meanINS_9QuantRowsELi2EEEvT_PKfPfii":
            (48, 0),
        "_ZN12_GLOBAL__N_111pass1_ranksINS_9QuantRowsELi16ELi2ELb1EEEvT_"
        "PKfPfiii": (72, 0),
        "_ZN12_GLOBAL__N_114pass1_partialsINS_9DenseRowsEEEvT_PKfPfiii":
            (40, 0),
        "_ZN12_GLOBAL__N_114reduce_partialsEPKfPfii": (20, 0),
        "_ZN12_GLOBAL__N_117block_topd_kernelEPKfiiiiPfPiS3_S3_": (64, 0),
    }
    log = "".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes "
        f"spill loads\nptxas info    : Used {regs} registers, 400 bytes "
        "cmem[0]\n" for name, (regs, spill) in entries.items())
    assert chip_smoke.ptxas_report(log) == {
        "block_topd_kernel":
            "64 registers, 0 B spill stores, 0 B spill loads",
        "combine_mean<QuantRows, 2>":
            "48 registers, 0 B spill stores, 0 B spill loads",
        "combine_ranks<DenseRows, 16, 2, C == B>":
            "79 registers, 0 B spill stores, 0 B spill loads",
        "combine_ranks<QuantRows, 64, 1, C < B>":
            "255 registers, 12 B spill stores, 12 B spill loads",
        "pass1_partials<DenseRows>":
            "40 registers, 0 B spill stores, 0 B spill loads",
        "pass1_ranks<QuantRows, 16, 2, vector>":
            "72 registers, 0 B spill stores, 0 B spill loads",
        "pd_kernel<3, 4, 1, fp32>":
            "96 registers, 0 B spill stores, 0 B spill loads",
        "pd_kernel<8, 4, 1, int8>":
            "128 registers, 0 B spill stores, 0 B spill loads",
    }
