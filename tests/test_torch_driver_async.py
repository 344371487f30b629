"""The chunked driver on the buffered-async engine: ``run_async`` with
stragglers, chunks of 1 and 4, scan bitwise the per-round loop on the
CPU.  One of the nine files of ``tests/test_torch_driver.py``'s cases
(see its docstring).
"""
import pytest

from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import MLP_CONFIG
from repro_torch.core import async_engine
from repro_torch.core.faults import FaultConfig
from repro_torch.data.pipeline import build_federation
from repro_torch.models.model import build
from torch_driver_cases import _bitwise, one_thread  # noqa: F401


# ----------------------------------------------------- the async engine --
@pytest.mark.parametrize("chunk", [1, 4])
def test_run_async_scan_matches_python_bitwise(chunk):
    model = build(MLP_CONFIG)
    fed, test = build_federation(0, kind="tabular", n=600, n_clients=24,
                                 batch_size=8, eval_batch=8, device="cpu")
    cfg = FedConfig(n_clients=4, population=24, local_epochs=2,
                    local_lr=0.05, aggregator="trimmed_mean",
                    async_max_retries=2, select_method="pallas")
    late = FaultConfig(straggler_frac=0.3, straggler_delay=3.0,
                       base_delay=0.3)

    def evaluate(params):
        _, m = model.loss(params, test)
        return {"test_acc": m["acc"]}

    runs = [async_engine.run_async(
        model, cfg, fed.data, 6, 2, eval_fn=evaluate, batch_size=8,
        eval_batch=8, device="cpu", faults=late, driver=drv,
        chunk_rounds=chunk) for drv in ("python", "scan")]
    _bitwise(runs[1], runs[0])
    assert sum(float(r["buffered"]) for r in runs[1][1]) > 0
