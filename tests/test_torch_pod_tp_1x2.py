"""The pod step on a state placed over a 1 x 2 (data, model) gloo mesh of two
spawned processes (tensor parallelism only), on tiny-lm at small widths,
against the same step unsharded (``tests/torch_pod_tp_cases.py``), for
``robust=None``, per_client fedavg, trimmed_mean and krum, and int8: teams
and h equal, params and trust within 1e-5, theta within 5e-4.
"""
import torch_pod_tp_cases as tp

(_one_thread, ranks,
 test_placed_step_1x2_matches_unsharded) = tp.module_tests(
    (1, 2), ["attn"], sorted(tp.ROBUST))
