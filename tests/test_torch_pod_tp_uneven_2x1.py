"""The pod step on a state placed over a 2 x 1 (data, model) gloo mesh for
head counts that do not split over "model" at small widths
(``tests/torch_pod_tp_cases.py``): attention with 3 q heads in one kv group
and an mLSTM stack with 3 heads, whose projections are read padded to an
even head split (2 kv groups, 4 mLSTM heads) as GSPMD pads them where
"model" splits them (on a model axis of 1 they run whole), against
the same step unsharded, under ``robust=None`` and per_client fedavg:
teams and h equal, params and trust within 1e-5, theta within 5e-4.
"""
import torch_pod_tp_cases as tp

(_one_thread, ranks,
 test_placed_uneven_heads_2x1_match_unsharded) = tp.module_tests(
    (2, 1), ["attn_uneven", "xlstm_uneven"], ["none", "fedavg"])
