"""Checkpoints of a placed pod state and the training CLI over a model
axis, on gloo groups of spawned processes (each joined under a timeout).

  * a state placed over 2 x 2 by ``param_specs`` (tiny-lm at small widths,
    AdamW, after one step) saves in the JAX package's format, gathered
    whole; it restores bitwise into a 2 x 2 placed state
    (``restore(sharding_tree=)``), into a 1 x 1 placed state and into a
    plain one;
  * ``python -m repro_torch.launch.train --model-axis 2`` over two
    processes (a 1 x 2 mesh: the state placed TP over "model", the
    per-client grads on the TP copy) against the same run in one process:
    rows within 1e-5 (theta within 5e-4), the final params within 1e-4.
    The CLI trains with AdamW, whose update m / (sqrt(v) + eps) divides
    by the grad's own size: an element whose grad is at the rounding level
    moves by up to lr = 3e-4 either way (one element of 131,072 moved by
    1.2e-5 here), so the params are held to a third of lr.
"""
import queue as queue_mod
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.core import pod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train
from repro_torch.models import transformer
from repro_torch.optim import optimizers
from repro_torch.sharding import dtensor, specs

TIMEOUT = 240
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=128, head_dim=16)
CFG = ARCHS["tiny-lm"].replace(**SMALL)
C, GB, S = 4, 8, 16
CLI = ["--arch", "tiny-lm", "--reduced", "--device", "cpu", "--clients",
       "2", "--global-batch", "4", "--seq", "16", "--steps", "2",
       "--robust", "per_client", "--driver", "python"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(mesh=None):
    tc = TrainConfig(global_batch=GB, seq_len=S, total_steps=4,
                     warmup_steps=1)
    opt_init, _ = optimizers.make_optimizer(tc)
    params = transformer.init_transformer(torch.Generator().manual_seed(0),
                                          CFG)
    fed = FedConfig(n_clients=C)
    sh = None if mesh is None else (
        lambda st: specs.named(mesh, specs.param_specs(st, mesh=mesh)))
    state = pod.init_pod_state(params, opt_init, C, fed,
                               torch.Generator().manual_seed(1),
                               shardings=sh)
    return state, pod.make_train_step(CFG, fed, tc), sh


def _batch(mesh=None):
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, CFG.vocab_size, (GB, S + 1)))
    b = {"tokens": toks[:, :-1].clone(), "targets": toks[:, 1:].clone()}
    if mesh is None:
        return b
    from repro_torch.launch import inputs
    bsh = inputs.batch_shardings(b, mesh)
    return {k: bsh[k].local(v) for k, v in b.items()}


def _host(t):
    def one(v):
        if isinstance(v, torch.Generator):
            return v.get_state().numpy().copy()
        return v if v is None else v.numpy().copy()

    return tree.map(one, dtensor.whole(t))


def _ckpt_worker(rank, store_dir, path):
    mesh = mesh_mod.make_host_mesh(2, 2)
    state, step, sh = _state(mesh)
    state, _ = step(state, _batch(mesh))
    ckpt.save_step(path, 1, state)
    fresh, _, _ = _state(mesh)
    back, at = ckpt.restore_latest(path, fresh, sh(fresh))
    assert at == 1
    leaf = back.params["layers"]["b0"]["attn"]["wq"]
    assert dtensor.is_dtensor(leaf) and leaf.placements == \
        state.params["layers"]["b0"]["attn"]["wq"].placements
    return {"saved": _host(state), "restored": _host(back)}


def _cli_worker(rank, store_dir, path):
    st, rows = train.main(CLI + ["--model-axis", "2"])
    return {"state": _host(st), "rows": rows}


def _worker(fn, rank, W, store_dir, path, out_q):
    try:
        torch.set_num_threads(1)
        mesh_mod.start_group("cpu", world_size=W, rank=rank,
                             store_dir=store_dir)
        out_q.put((rank, fn(rank, store_dir, path)))
    except Exception:                   # reported by the test, not lost
        out_q.put((rank, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _spawn(fn, W, tmp):
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    store_dir = str(tmp / "store")
    (tmp / "store").mkdir()
    procs = [ctx.Process(target=_worker,
                         args=(fn, r, W, store_dir, str(tmp / "ckpt"),
                               out_q)) for r in range(W)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:                 # drain before joining
            rank, out = out_q.get(timeout=TIMEOUT)
            results[rank] = out
    except queue_mod.Empty:
        pytest.fail(f"the {W} processes did not finish in {TIMEOUT} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    for rank, out in results.items():
        if isinstance(out, str):
            pytest.fail(f"rank {rank} failed:\n{out}")
    return results


def _bitwise(a, b):
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert (x is None and y is None) or (
            x.dtype == y.dtype and x.tobytes() == y.tobytes())


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_2x2")
    return _spawn(_ckpt_worker, 4, tmp), tmp / "ckpt"


def test_save_2x2_restores_bitwise_at_2x2(saved):
    ranks, _ = saved
    for r in ranks:
        _bitwise(ranks[r]["restored"], ranks[0]["saved"])
        _bitwise(ranks[r]["saved"], ranks[0]["saved"])


@pytest.mark.parametrize("placed", [True, False])
def test_save_2x2_restores_bitwise_at_1x1(saved, placed):
    ranks, path = saved
    with mesh_mod.host_mesh(device="cpu") as mesh:
        fresh, _, sh = _state(mesh if placed else None)
        back, at = ckpt.restore_latest(str(path), fresh,
                                       sh(fresh) if placed else None)
        assert at == 1
        leaf = back.params["embed"]
        assert dtensor.is_dtensor(leaf) == placed
        _bitwise(_host(back), ranks[0]["saved"])


def test_cli_model_axis_2_matches_one_process(tmp_path):
    ranks = _spawn(_cli_worker, 2, tmp_path)
    st, rows = train.main(CLI)
    ref = _host(st)
    for r in ranks:
        for a, b in zip(tree.leaves(ranks[r]["state"].params),
                        tree.leaves(ref.params)):
            np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_array_equal(ranks[r]["state"].fed.team,
                                      ref.fed.team)
        for gr, rr in zip(ranks[r]["rows"], rows):
            for k, v in rr.items():
                if k in ("wall_ms", "chunk_ms"):
                    continue
                np.testing.assert_allclose(
                    gr[k], v, rtol=1e-5, err_msg=k,
                    atol=5e-4 if k == "theta_team" else 1e-5)
