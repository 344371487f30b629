"""Shared cases of the chunked-driver tests (``tests/test_torch_driver*.py``,
one file a share of the cases, so that the suite's workers split them):
the sync engine's cases, their setup and the bitwise comparison of two
runs.  See ``tests/test_torch_driver.py`` for what the files check.
"""
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import CNN_CONFIG
from repro_torch.core import attacks, fedfits
from repro_torch.core.faults import FaultConfig
from repro_torch.data.pipeline import build_federation
from repro_torch.models.model import build

K, ROUNDS, ATOL = 6, 7, 1e-5
CHUNK = 3
HOST_KEYS = ("wall_ms", "chunk_ms")           # host clocks, not results


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are tiny: one intra-op thread keeps the suite's
    parallel workers from oversubscribing the cores (a file's runs share
    the setting, so its bitwise comparisons stand)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gauss(upd, mal, noise):
    return attacks.gaussian_update(upd, mal, 0.05, noise)


_gauss.draws_noise = True
_MAL = torch.tensor([1.0, 1.0] + [0.0] * (K - 2))
_FAULTS = FaultConfig(straggler_frac=0.25, straggler_delay=3.0,
                      base_delay=0.3, dropout_prob=0.3, partial_min_frac=0.3)
_SYNC = {
    "avail": (dict(avail_prob=0.7, explore_eps=0.3), {}),
    "int8_ef": (dict(compress="int8", error_feedback=True,
                     aggregator="trimmed_mean"), {}),
    "faults": (dict(aggregator="krum"), dict(faults=_FAULTS)),
    "noisy_attack": (dict(aggregator="trimmed_mean"),
                     dict(update_attack=_gauss, malicious=_MAL)),
    "cross_round": (dict(aggregator="trimmed_mean"), dict(
        update_attack="cross_round", malicious=_MAL)),
}


@pytest.fixture(scope="module")
def sync_setup():
    model = build(CNN_CONFIG.replace(d_model=4, d_ff=16))
    fed, test = build_federation(0, kind="images", n=480, n_clients=K,
                                 batch_size=8, eval_batch=8, device="cpu")

    def evaluate(params):
        _, m = model.loss(params, test)
        return {"test_acc": m["acc"]}

    return model, fed, evaluate, {}


def _sync_run(setup, case, drv, chunk=8):
    model, fed, evaluate, _ = setup
    kw, extra = _SYNC[case]
    cfg = FedConfig(n_clients=K, algorithm="fedfits", local_epochs=2,
                    local_lr=0.05, msl=3, pft=2, **kw)
    extra = dict(extra)
    if extra.get("update_attack") == "cross_round":
        extra["update_attack"] = attacks.CrossRoundGateAware(cfg)
    return fedfits.run(model, cfg, fed.data_fn, ROUNDS, 3, eval_fn=evaluate,
                       device="cpu", driver=drv, chunk_rounds=chunk, **extra)


def _bitwise(a, b):
    """Two (state, history) runs bit for bit."""
    (sa, ha), (sb, hb) = a, b
    assert len(ha) == len(hb)
    for ra, rb in zip(ha, hb):
        assert set(ra) - set(HOST_KEYS) <= set(rb)
        for k, v in ra.items():
            if k in HOST_KEYS:
                continue
            x, y = np.asarray(v), np.asarray(rb[k])
            assert (x.dtype, x.shape) == (y.dtype, y.shape), k
            assert x.tobytes() == y.tobytes(), (k, ra["round"])
    la, lb = tree.leaves(sa), tree.leaves(sb)
    assert len(la) == len(lb)
    rows = getattr(getattr(sa, "buf", None), "rows", None)
    for x, y in zip(la, lb):
        if rows is not None and x is rows:
            # the async buffer's drop row takes the dropped parks by an
            # index_copy_ with duplicate indices, in no set order even on
            # the CPU's threads; it is never read
            x, y = x[:-1], y[:-1]
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)



def check_sync_case(setup, case, chunk):
    """``fedfits.run(driver="scan")`` at ``chunk`` bitwise the per-round
    loop (run once a case and module, kept in the setup)."""
    refs = setup[3]
    if case not in refs:
        refs[case] = _sync_run(setup, case, "python")
    out = _sync_run(setup, case, "scan", chunk)
    _bitwise(out, refs[case])
    assert [r["round"] for r in out[1]] == list(range(1, ROUNDS + 1))
