"""The pod step on a state placed over a 1 x 2 (data, model) gloo mesh of two
spawned processes for each block kind past plain attention (MoE, the
attention | mamba hybrid, mLSTM / sLSTM, cross-attention) at small
widths, against the same step unsharded (``tests/torch_pod_tp_cases.py``),
under ``robust=None`` and per_client fedavg: teams and h equal, params and
trust within 1e-5, theta within 5e-4.  Every robust case of each kind
runs at 2 x 2 (``test_torch_pod_tp_<kind>.py``).
"""
import torch_pod_tp_cases as tp

(_one_thread, ranks,
 test_placed_blocks_1x2_match_unsharded) = tp.module_tests(
    (1, 2), ["moe", "hybrid", "xlstm", "xattn"], ["none", "fedavg"])
