"""The pod step on a state placed over a 2 x 2 (data, model) gloo mesh:
FSDP x tensor parallelism by ``param_specs``, four spawned processes, on
tiny-lm at small widths, against the same step unsharded
(``tests/torch_pod_tp_cases.py``): ``robust=None`` (the weighted backward
on DTensors), ``robust='per_client'`` with fedavg, trimmed_mean and krum
(each data index's clients' grads on a TP copy, the aggregation over the
mesh) and int8 (the fused-dequant path): teams and h equal, params and
trust within 1e-5, theta within 5e-4.  Every rank returns the same whole
params.

And the aggregation over a part of the mesh: ``aggregate_sharded`` and
``fused_dequant_aggregate_sharded`` with ``axes=("model",)`` and
``("data",)`` on the 2 x 2 mesh, each sub-group of two ranks sharding the
flat axis between them, against ``aggregation.aggregate`` and
``fused_dequant_aggregate_tree`` on every row within 1e-5, for all four
aggregators; every rank holds the same result.

And ``aggregation.aggregate_tp`` (the per-client path's aggregation of the
pieces of a tensor-parallel copy): each rank's block of the columns split
over "model" and the whole columns, on its data index's clients, against
``aggregate`` of the whole matrix within 1e-5, for all four aggregators
(on data where Krum's choice changes if the whole columns count twice).
"""
import numpy as np
import pytest
import torch

import torch_pod_tp_cases as tp
from repro_torch.comm.kernels import comm_codecs as dq
from repro_torch.configs.base import FedConfig
from repro_torch.core import aggregation

SHAPE = (2, 2)
CASES = sorted(tp.ROBUST)
AXES = [("model",), ("data",)]
AGGS = ["fedavg", "median", "trimmed_mean", "krum"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = ([("attn", c) for c in CASES] + [("axes", a) for a in AXES]
             + [("tp", None)])
    return tp.spawn(SHAPE, cases, str(tmp_path_factory.mktemp("pod_tp")))


@pytest.mark.parametrize("case", CASES)
def test_placed_step_2x2_matches_unsharded(ranks, case):
    ref = tp.run("attn", case)
    for r in ranks:
        tp.check(ranks[r]["attn", case], ref)


@pytest.mark.parametrize("axes", AXES, ids=lambda a: a[0])
@pytest.mark.parametrize("agg", AGGS)
def test_aggregation_over_a_sub_group(ranks, axes, agg):
    w, m = tp.agg_wm()
    full = tp.agg_tree()
    cfg = FedConfig(n_clients=tp.AGG_C, aggregator=agg)
    enc, layout, like = tp.agg_record(full)
    refs = {"dense": aggregation.aggregate(full, w, m, cfg),
            "int8": dq.fused_dequant_aggregate_tree(enc, layout, w, m, cfg,
                                                    like=like)}
    for kind, ref in refs.items():
        for r in ranks:
            got = ranks[r]["axes", axes][kind, agg]
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k].numpy(),
                                           atol=tp.ATOL, err_msg=k)
                np.testing.assert_array_equal(
                    got[k], ranks[0]["axes", axes][kind, agg][k])


@pytest.mark.parametrize("agg", AGGS)
def test_aggregate_tp_matches_aggregate(ranks, agg):
    split, whole = tp.tp_updates()
    w, m = tp.agg_wm()
    cfg = FedConfig(n_clients=tp.AGG_C, aggregator=agg)
    ref = aggregation.aggregate(
        {"u": torch.from_numpy(np.concatenate([split, whole], 1))}, w, m,
        cfg)["u"].numpy()
    ref_split, ref_whole = ref[:tp.TP_SPLIT], ref[tp.TP_SPLIT:]
    M = SHAPE[1]
    for r in ranks:
        got_split, got_whole = ranks[r]["tp", None][agg]
        b = tp.TP_SPLIT // M * (r % M)
        np.testing.assert_allclose(
            got_split, ref_split[b:b + tp.TP_SPLIT // M], atol=tp.ATOL)
        np.testing.assert_allclose(got_whole, ref_whole, atol=tp.ATOL)
