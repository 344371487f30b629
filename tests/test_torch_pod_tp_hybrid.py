"""The pod step on a state placed over a 2 x 2 (data, model) gloo mesh for the
attention | mamba hybrid (hymba at small widths; the chunked scan runs on
each rank's rows with its channels gathered), against the same step
unsharded (``tests/torch_pod_tp_cases.py``), under ``robust=None``,
per_client fedavg, trimmed_mean and krum, and int8: teams and h equal,
params and trust within 1e-5, theta within 5e-4.
"""
import torch_pod_tp_cases as tp

(_one_thread, ranks,
 test_placed_hybrid_step_2x2_matches_unsharded) = tp.module_tests(
    (2, 2), ["hybrid"], sorted(tp.ROBUST))
