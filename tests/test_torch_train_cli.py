"""The port's training entry point, ``python -m repro_torch.launch.train``,
on the CPU: it prints its JSON rows and ``done``; a run resumed from its
``--ckpt-dir`` checkpoint gives the uninterrupted run's rows and final
state bit for bit (the batches of step t come from a generator seeded by
(seed, t), the state's generator is in the checkpoint); the flag checks of
the JAX CLI refuse what they refuse there; ``--scenario`` runs a registry
cell."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--arch", "tiny-lm", "--reduced", "--device", "cpu",
         "--clients", "2", "--global-batch", "4", "--seq", "16"]
HOST_KEYS = ("wall_ms", "chunk_ms")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are tiny: one intra-op thread keeps the suite's
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_prints_rows_and_done():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "tiny-lm", "--reduced", "--device", "cpu", "--steps", "3",
         "--robust", "per_client"],
        env=env, capture_output=True, text=True, timeout=300, check=True)
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "done"
    rows = [json.loads(l) for l in lines[:-1]]
    assert [r["step"] for r in rows] == [0, 2]       # every 5th and the last
    for r in rows:
        assert {"loss", "acc", "grad_norm", "theta_team", "team_size",
                "alpha", "wall_s"} <= set(r)
        assert np.isfinite(r["loss"]) and r["team_size"] >= 1


def _same(a, b):
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("extra", [[], ["--compress", "int8"]],
                         ids=["dense", "int8"])
def test_ckpt_resume_equals_the_uninterrupted_run(tmp_path, extra):
    args = [*SMALL, "--steps", "6", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3", "--robust", "per_client",
            "--aggregator", "median", *extra]
    st_a, rows_a = train.main(args)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000006"]
    shutil.rmtree(tmp_path / "step_00000006")
    st_b, rows_b = train.main(args)                   # resumes at step 3
    assert [r["step"] for r in rows_b] == [3, 4, 5]
    for ra, rb in zip(rows_a[3:], rows_b):
        for k, v in ra.items():
            if k not in HOST_KEYS:
                assert np.asarray(v).tobytes() == np.asarray(
                    rb[k]).tobytes(), k
    _same(st_a, st_b)
    st_c, rows_c = train.main(args)                   # nothing left to run
    assert rows_c == [] and int(st_c.step) == 6


@pytest.mark.parametrize("argv,match", [
    (["--population", "64"], "need --scenario"),
    (["--compress", "int8"], "needs --robust per_client"),
    (["--scenario", "gate_aware_int8_dropout", "--population", "64"],
     "dense-uplink only"),
])
def test_cli_refuses_what_the_jax_cli_refuses(argv, match, capsys):
    with pytest.raises(SystemExit):
        train.main([*SMALL, *argv])
    assert match in capsys.readouterr().err


def test_cli_runs_a_scenario_cell(capsys):
    train.main(["--scenario", "alie_fedavg", "--steps", "2", "--clients",
                "4", "--device", "cpu", "--driver", "python"])
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(l) for l in lines]
    assert [r["round"] for r in rows[:-1]] == [1, 2]
    assert "test_acc" in rows[0] and isinstance(rows[-1], dict)
