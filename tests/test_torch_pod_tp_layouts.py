"""``robust=None`` in the other layouts over gloo meshes of spawned
processes, against the same step unsharded (``tests/torch_pod_tp_cases.py``):
``moe_ff`` (the MoE stack placed by ``param_specs_moe_ff``) with params and
trust within 1e-5; ZeRO-1 on tiny-lm (``param_specs_tp`` compute,
``param_specs`` master) and ``zero1_moe`` on the MoE stack
(``param_specs_zero1_moe`` compute, ``param_specs_moe_ff`` master) against
the unsharded ZeRO-1 step on a 1 x 1 mesh: teams and h equal, loss and
grad_norm within 1e-2 relative (bf16 compute), each param within 1e-2 of
the largest param change.  At 2 x 2 and 1 x 2 the all-gathers into the
compute layout and the reduce-scatters into the master layout run.
"""
import pytest
import torch

import torch_pod_tp_cases as tp

CASES = [("attn", "zero1"), ("moe", "moe_ff"), ("moe", "zero1_moe")]
SHAPES = [(2, 2), (1, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "%dx%d" % s)
def ranks(request, tmp_path_factory):
    return tp.spawn(request.param, CASES,
                    str(tmp_path_factory.mktemp("pod_tp_layouts")))


@pytest.mark.parametrize("kind,case", CASES, ids=lambda x: x)
def test_layout_step_matches_unsharded(ranks, kind, case):
    ref = tp.run(kind, case)
    for r in ranks:
        tp.check(ranks[r][kind, case], ref, case)
