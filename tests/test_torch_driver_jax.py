"""The port's scan run against the JAX package's ``driver="python"`` run,
on the JAX init and batches: teams and h exact, params within atol 1e-5,
the tolerance of ``tests/test_torch_slice.py`` (conv, matmul and the
aggregation sums run in other orders).  One of the nine files of
``tests/test_torch_driver.py``'s cases (see its docstring).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.configs.paper_models import CNN_CONFIG as JCNN
from repro.core import fedfits as jfedfits
from repro.data.pipeline import build_federation as jbuild_federation
from repro.models.model import build as jbuild
from repro_torch import interop, tree
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import CNN_CONFIG
from repro_torch.core import fedfits
from repro_torch.models.model import build
from torch_driver_cases import ATOL, K, one_thread  # noqa: F401


# --------------------------------------------------- against the JAX run --
@pytest.mark.parametrize("aggregator", ["fedavg", "trimmed_mean"])
def test_scan_run_matches_jax_python_driver(aggregator):
    jmodel = jbuild(JCNN.replace(d_model=4, d_ff=16))
    jfed, _ = jbuild_federation(0, kind="images", n=600, n_clients=K,
                                batch_size=16, eval_batch=16)
    batches = []

    def jdata_fn(t, rng):
        b = jfed.data_fn(t, rng)
        batches.append(jax.tree_util.tree_map(np.asarray, b))
        return b

    def jeval(params):
        return {f"p{i}": l for i, l in
                enumerate(jax.tree_util.tree_leaves(params))}

    rng = jax.random.PRNGKey(0)
    init = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.split(rng)[0]))
    fed_kw = dict(n_clients=K, algorithm="fedfits", local_epochs=2,
                  local_lr=0.05, msl=4, pft=2, aggregator=aggregator)
    _, jhist = jfedfits.run(jmodel, JFedConfig(**fed_kw), jdata_fn, 4, rng,
                            eval_fn=jeval, driver="python")

    model = build(CNN_CONFIG.replace(d_model=4, d_ff=16))
    model = dataclasses.replace(
        model, init=lambda gen: interop.params_from_numpy(init))

    def data_fn(t, gen):
        return {k: torch.from_numpy(np.array(v))
                for k, v in batches[t - 1].items()}

    def evaluate(params):
        return {f"p{i}": l for i, l in enumerate(tree.leaves(params))}

    _, hist = fedfits.run(model, FedConfig(**fed_kw), data_fn, 4, 0,
                          eval_fn=evaluate, device="cpu", driver="scan",
                          chunk_rounds=3)
    for t, (row, ref) in enumerate(zip(hist, jhist), start=1):
        np.testing.assert_array_equal(row["team"], ref["team"],
                                      err_msg=f"team, round {t}")
        assert bool(row["h_next"]) == bool(ref["h_next"]), t
        np.testing.assert_allclose(row["score"], ref["score"], atol=ATOL)
        for i in range(len(tree.leaves(init))):
            np.testing.assert_allclose(row[f"p{i}"], ref[f"p{i}"],
                                       atol=ATOL,
                                       err_msg=f"leaf {i}, round {t}")
