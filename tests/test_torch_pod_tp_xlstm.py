"""The pod step on a state placed over a 2 x 2 (data, model) gloo mesh for an
xLSTM stack (one mLSTM and one sLSTM block at small widths; both
recurrences run on gathered heads and weights), against the same step
unsharded (``tests/torch_pod_tp_cases.py``), under ``robust=None``,
per_client fedavg, trimmed_mean and krum, and int8: teams and h equal,
params and trust within 1e-5, theta within 5e-4.
"""
import torch_pod_tp_cases as tp

(_one_thread, ranks,
 test_placed_xlstm_step_2x2_matches_unsharded) = tp.module_tests(
    (2, 2), ["xlstm"], sorted(tp.ROBUST))
