"""The pod step on a state placed over a 2 x 1 (data, model) gloo mesh of two
spawned processes (FSDP and data parallelism only), on tiny-lm at small
widths, against the same step unsharded (``tests/torch_pod_tp_cases.py``),
for ``robust=None``, per_client fedavg, trimmed_mean and krum, and int8:
teams and h equal, params and trust within 1e-5, theta within 5e-4.
"""
import torch_pod_tp_cases as tp

(_one_thread, ranks,
 test_placed_step_2x1_matches_unsharded) = tp.module_tests(
    (2, 1), ["attn"], sorted(tp.ROBUST))
