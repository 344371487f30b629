#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failure raises, so the exit code is not 0):
  1. card     nvidia-smi's name and power limit, the device, the build of
              every CUDA kernel from src/repro_torch/csrc (nvcc, sm_90a),
              and ptxas's registers and spills for K9's two bodies, the
              Gram's (K3 / K6c), the combine's register bodies
              (``combine_mean``, ``combine_ranks``), pass 1's
              (``pass1_ranks<source, bucket, columns a thread, loads>``,
              and ``pass1_partials<source>`` past 64 rows), K8's
              (``pd_kernel<row block, vector, vectors a lane, pool>``) and
              K7's (``block_topd_kernel``).
  2. kernels  each kernel against its plain PyTorch version on the card,
              at the main path's shape (G=1, C=16, N=421,642) and at
              (G=2, C=64, N=65,573) with ragged N, an empty cohort and a
              one-member cohort.  The fused-dequant kernels K6a-c read
              int8 codes made by the port's own codec, over paper-cnn's 8
              leaves (and 4 ragged leaves at the wide shape); they are also
              held bitwise against K1-K3 on the masked decode, and a
              masked-out client whose scale is inf must leave the outputs
              finite.  K5 (``robust_agg_fwd``, csrc/robust_agg.cu) in both
              modes at the main and the wide shape under full, mixed,
              one-member and empty masks: the median bitwise its plain
              version, the empty mask exactly 0, and bitwise K2 under the
              same mask.  The flat wrappers K4a-c bitwise K1-K3 (the flat
              tree path against the other, all four aggregators), a tree's
              8 leaves through the segment table (``rp_*_seg``) bitwise
              the one matrix they were cut from, timed beside concatenating
              them first, the two-stage scheme at G=2 against its plain path, and K3
              and K6c at C=96 (six 32 x 32 output tiles a split).  Times
              by CUDA events, K3's and K6c's printed beside those of the
              design before the register micro-tiles (GRAM_BEFORE_MS) and,
              with ``bmm``'s, by torch.profiler (device only).  K2's body in
              each entry point (K2, K4b, K5, K6b) is also timed device only
              (``w @ X`` beside the mean) and printed beside the shared-tile
              design's times (K2_BEFORE_MS); the mean's wrapper is timed on
              the host over HOST_CALLS calls with no synchronize.  Pass 1
              (K1, K4a, K6a) at C on both sides of each register bucket's
              edge and past 64 rows (1-130) and N = 0-3 mod 4, in a cohort
              with a masked-out row and ties, an empty and a lone one, and
              on unaligned copies of its inputs: K1 and K6a against their
              plain versions, K4a bitwise K1, K6a bitwise K1 on the masked
              decode, two calls bitwise equal; then a masked-out row of inf
              and a masked-in NaN (``repro_torch.kernels.pass1_checks``,
              the card tests' own cases).  K1, K4a and K6a
              are timed device only beside the shared-tile design's device
              times (K1_BEFORE_MS), and K1 also at the async path's 48
              rows.
  2b. top-d   K7 (``block_topd`` for stage 1, ``topd_pallas`` for the
              fused launch that also merges) against its plain versions on
              the card over ``repro_torch.kernels.topd_checks.CASES`` (the
              card tests' own cases): Gumbel keys at M=1,000,000/d=64 and
              M=16,384/d=16 (the async path's shape), ragged and exhausted
              blocks (whose candidates repeat the block's first index at
              -inf), M=4,097, d = 1, 1,024 and blk, duplicates, +-0.0
              mixtures, all-equal keys (at 10^6 the merge reads every
              candidate), exactly d finite keys a block, mostly -inf keys
              and unaligned views: the candidates bitwise
              ``block_topd_plain``'s, the fused launch's indices bitwise the
              CPU path's (``block_topd_plain`` then ``_merge``), one launch
              a call; where no +-0.0 or exhausted tail reaches the top-d,
              every route and ``torch.topk`` give argsort's order; M=40,
              d=64 takes the argsort route and must not launch K7.  Times at
              TOPD_TIMED by CUDA events and device only: the fused launch,
              stage 1 alone, ``torch.topk`` and the plain version, beside
              the bound and the earlier design's (K7_BEFORE_MS).  Past the
              shared-memory budget (``topd_checks.LARGE_CASES``: d = 16,385
              and 20,000 at M = 10^5, duplicates, +-0.0, -inf tails,
              unaligned) ``topd_pallas`` must take K7's global path and
              give the CPU path's indices bitwise, while d = 16,384 and
              TOPD_TIMED keep the one-launch path; the global path is timed
              at TOPD_LARGE_TIMED beside its bound and ``torch.topk``.
  3. round    the port's main path: the full-width paper-cnn FedFiTS round
              through ``fedfits.run`` and its default chunked driver (the
              round captured once as a CUDA graph and replayed, one host
              read a chunk of 8), 10 rounds under fedavg, then 2 each
              under trimmed_mean, median and krum; every kernel must have
              launched (replays count); round 1 is run again through the
              CPU port and must give the same team and the same params.
              Phases 4-6 run through the same driver.
  4. compressed round
              the same round with ``compress="int8"`` and error feedback:
              4 rounds under fedavg, then 2 each under trimmed_mean, median
              and krum, through K6a-c (each must have launched); it must
              bill 434,830 B per client-round and the dense path's
              client-rounds; round 1 again on the CPU must give the same
              team and params within one quantisation step.  Then one
              trimmed_mean round each of int4, signsgd, topk and randk.
  5. async round
              the buffered-async engine at full width through
              ``async_engine.run_async``: paper-cnn over M=16,384
              registered clients (n=131,072 images, Dirichlet 1.0), cohort
              C=16, retry buffer B=32, chronic stragglers, cohorts drawn by
              K7; 8 rounds under trimmed_mean, then 2 each under fedavg,
              median and krum.  K7 must launch once a round and K1, K2 in
              each mode and K3 at least once; billing must be exactly 16
              client-rounds and 16 dense uplinks a round; deliveries must
              park and land; trimmed_mean test_acc must rise; round 1 again
              on the CPU port with the card's draws must give the same
              cohort, on-time mask and buffer, params within 1e-5.
  5b. parity  driver="scan" against driver="python" on the card, the per-
              round loop run twice, under cuDNN's deterministic algorithms:
              paper-cnn FedFiTS with availability 0.8 and explore 0.1
              under fedavg, trimmed_mean and krum and int8 with error
              feedback (7 rounds, chunks of 3, so the last is partial),
              the async trimmed_mean round at M=16,384 with stragglers (7
              rounds, chunks of 4), and the registry cell
              ``hetero_fedfits`` with a Gaussian update attack (stragglers,
              partial work, a noisy attack; 6 rounds through
              ``run_scenario``): every state tensor and history value
              bitwise, the kernels' launches equal.  Then fedavg under
              cuDNN's default algorithms, whose conv backward does not
              repeat: the two loops differ, and scan must give the loop's
              masks and every other value within PARITY_DEFAULT_ATOL.
  5c. timing  the round wall under both drivers in this run
              (``repro_torch.launch.profile_round.measure``): the sync
              fedavg and the async trimmed_mean round, median of 10 steady
              rounds (one host read each), the scan driver's wall a round
              over a chunk of 10, and one traced round's device busy time,
              idle share and launches from the host.
  5d. telemetry
              sync fedavg and async trimmed_mean at phase 5b's shapes under
              the default (replayed) driver with an ``obs.Telemetry`` (a
              JSONL sink and a trace) and without: bitwise the same run
              but the obs/ keys under cuDNN's deterministic algorithms,
              the counter column's totals the rows' sums, the artifacts
              passing ``python -m repro_torch.obs.check --require-obs
              --min-phases 5``; then the replayed round's wall median and
              launches from the host with telemetry on and off
              (``profile_round.measure``).
  6. robustness
              (a) the port's examples/poisoning_defense.py: paper-mlp on
              the tabular federation (n=1600, K=10, 22 classes), 2 clients
              sign-flipping at 10x, 12 rounds under each aggregator and
              trimmed_mean again under int8 (which must bill the dense
              run's client-rounds); then one poisoned (10, 512) round
              through K5 (trimmed and median within 0.01 of the honest
              1.0), the flat tree path K4a-c under each aggregator and the
              two-stage scheme.  (b) named registry cells through
              ``run_scenario`` at paper-cnn width (images n=4000, K=16,
              6 rounds each; the async Krum cell with 4 retries, so K3
              takes C + B = 80 rows), one row each in the example's
              columns.  Each cell's aggregation kernels must launch, the
              dropout cell must lose updates, the cross-round attacker's
              blend must move, billing must count every team member
              (dropped ones too).  Two variants run beside their cells:
              ``hetero_fedfits`` with partial_min_frac=0.1 must stop
              clients early (the cell's own 0.5 cannot at E=2), and
              ``signflip_fedfits`` with the cosine gate at 0 must demote
              the sign-flippers' gate_trust below the honest clients' (at
              the cell's -0.5 the gate need not fire in 6 rounds).  Round 1 of hetero_fedfits,
              gate_aware_int8_dropout and async_late_poison_krum again on
              the CPU port with the card's draws: the same team or cohort,
              gated, lost and epoch masks, params within 1e-5 (int8: one
              quantisation step).
  2c. attention
              K8 (``paged_flash_decode``, csrc/paged_decode.cu) against its
              plain version at the serving shape (16 slots, Hq=24, Hkv=8,
              dh=128, page 16, 24 pages a slot; a slot with every page
              full, one with page + 1 rows, one with 1 row, one inactive,
              which must be exactly 0) and at tiny-lm's dh=64, g=2 with
              pages of 8 and 32, on fp32 and int8 pools and bf16 and fp32
              queries, two calls bitwise equal (the splits merge in a fixed
              order); K8's times also device only and its wrapper's host
              time, printed beside the shared-memory design's
              (K8_BEFORE_MS); K9 (``flash_attention_fwd``, csrc/flash_attention.cu)
              at B=2, Hq=24, Hkv=8, S=1024, dh=128 and at dh=64 with S=384
              and S=200 (ragged), bf16 (the tensor-core body: wgmma, TMA)
              and fp32 (the FMA body), window 0 and 256.  Times by CUDA
              events, K9's printed beside the FMA design's (K9_BEFORE_MS)
              and, with its library call's, by torch.profiler (device
              only); the library call is ``scaled_dot_product_attention``
              (causal, GQA; a boolean band for the window), which the port
              never calls.  Then K9 captured in a CUDA graph and replayed
              on new contents of its inputs must equal its eager call
              bitwise (its TMA maps are passed by value).
  7. serving  minitron-4b at full width and depth (5.1e9 parameters drawn
              in fp32 on the card, cast once to bf16) behind
              ``ServeEngine``: 16 slots, pages of 16, max_len 384, prompts
              of 128, K8 as the decode attention.  48 requests from
              ``draw_requests`` (generations log-uniform in [16, 256]) run
              continuously; every request must emit max_new tokens, every
              page come back, K8 launch 32 times a decode step.  A
              12-request subset (generations in [8, 64]) over 8 slots, so
              that continuous admits mid-run: the fixed engine must take
              more steps and give the same tokens; the ``attn="ref"``
              engine; int8 KV (every token, 3.88x fewer KV bytes); the
              dense full-cache loop.  First decode-step logits of 8
              requests, from a fresh state and from one where they land in
              recycled slots and pages beside live requests, must agree
              with the ref engine's within SERVE_LOGIT_REL of the largest
              (the same argmax where the top-2 gap exceeds that), and two
              paging faults of that state (a wrong first page, one stale
              row read) must fail the same check.  Then 13 steady decode
              steps at 16 slots, the last 3 traced (device busy, idle
              share, K8's share).  Prints decode-step ms and tokens/s
              beside the card.  The engines replay their decode step and
              their admission, each captured once as a CUDA graph; the 48
              requests run again with the admission eager (the same tokens,
              pools and SlotState with its counter column, bitwise; tokens/s
              and the admission's wall under both, and launches from the
              host an admission), 12 requests at temperature 0.7 both ways
              (bitwise), the 48 with an ``obs.Telemetry`` whose artifacts
              must pass ``repro_torch.obs.check``, and the 48 with both
              steps eager (``_decode`` and ``_admit``; the same tokens); the
              steady steps are timed and traced both ways (the eager trace
              names its copy kernels by shape).  Then 10 replayed decode
              steps against ``_decode`` eagerly on two copies of the same
              16-slot state, at temperature 0 and 0.7: tokens, lengths and
              pools bitwise.
  8. forward  ``Model.forward`` on (2, 1024) tokens at full width and
              depth with attn_impl="pallas": K9 must launch 32 times, the
              logits be finite, and the last hidden state agree with the
              plain attention's within FWD_HIDDEN_REL of the largest, while
              K9 with the keys more than 896 rows back dropped must fail
              that check; a 2-layer fp32 cut within 1e-4; the first decode
              step of that cut on the card and on the CPU port within 1e-4
              of the largest logit.  The params and pools are freed.
  9. pod      the pod trainer (``core/pod.py``) through its entry point
              ``launch/train.py`` (in process, NCCL at world size 1,
              ``--robust per_client``) at tiny-lm's full width and depth
              (64,233,984 fp32 parameters, C = 4, 16 x 256 tokens a
              step, AdamW): 20 fedavg steps (the loss must fall), 2 each
              of trimmed_mean, median and krum, int8 with error feedback
              4 fedavg and 2 krum steps (``comm_bytes_up`` by formula);
              each step must launch its path's kernels once (K1, K2, K3,
              K6a, K6b, K6c), and the counts join the kernels line.  Under
              deterministic algorithms: scan bitwise python (6 steps,
              chunks of 2), ``agg_mesh`` bitwise None, and a run resumed
              from its step-4 checkpoint bitwise the uninterrupted one;
              step 1 at 2 layers against the CPU port (SGD): the
              aggregated grads within POD_CPU_REL of their largest, and a
              step with one client's rows swapped for another's outside
              it; K1, K2, K3, K6a, K6b and K6c at (1, 4, 64,233,984)
              against their plain versions (NSUM_REL on the sums over N)
              and K3 / K6c against the fp64 Gram, timed
              beside bound and library (the kernels line's ``pod``
              entries); the step's wall, busy, launches and tokens/s
              under both drivers.  It runs in a child process
              (``python3 chip_smoke.py --pod``, which runs it alone) that
              fixes cuBLAS's workspace before cuBLAS starts.
  10. blocks  the other block kinds at their published widths, in two child
              processes (``python3 chip_smoke.py --blocks`` runs both
              alone; ``--blocks models`` / ``--blocks train`` one): K8 at
              granite's, dbrx's and musicgen's GQA groups (2, 6, 1), and
              K9 at each forward's heads and length (hymba's
              sliding-window band at g = 5, dh 64, window 1,024, S =
              2,048; dbrx's g = 6 and llama-3.2-vision's g = 8, dh 128, S
              = 512; musicgen's g = 1, dh 64, S = 1,024) in fp32 and bf16,
              against their plain versions, timed beside bound and SDPA.
              granite-moe-1b-a400m at full width and depth (1,385,219,072
              parameters, bf16) served by ``ServeEngine`` (16 slots, pages
              of 16, prompts of 128, 24 requests): every request its
              tokens, K8 once a layer and step, the first decode-step
              logits within SERVE_LOGIT_REL of the ref engine's, the eager
              steps the same tokens, 10 replayed decode steps bitwise
              ``_decode`` at T = 0 and 0.7.  hymba-1.5b at full depth:
              ``Model.forward`` at S = 2,048 through K9 (32 launches)
              within FWD_HIDDEN_REL of the plain attention, a 1,100-token
              prefill into the ring cache (W = 1,024) and the mamba state
              and 64 decode steps.  xlstm-350m and musicgen-large (frame
              embeddings in; K9 at g = 1) at full depth the same at S =
              1,024 with 16 decode steps, musicgen also served paged with
              a token table in front.  dbrx-132b cut to 2 layers (served
              too: K8 at g = 6) and llama-3.2-vision-90b to one cycle of 5
              layers (image embeddings (1, 1,601, 8,192), the
              cross-attention gate at 0.5): forward, prefill, 4 decode
              steps.  Every decode run once in fp32, each step within
              DECODE_FP32_REL of the full forward's logits at that
              position (xlstm: every layer an mLSTM at the 1,024-token
              prompt, and the published pattern at a 4-token prompt
              within XL_SLSTM_REL), and once in bf16 (timed), the first
              step within SERVE_LOGIT_REL.  Each model at full width and 2
              layers in fp32 on the card against the CPU port within
              ROUND1_LOGIT_REL, a swapped input (batch rows, image
              embeddings, or one expert's weights for dbrx) outside it.
              Then granite trained by ``launch/train.py`` (C = 4, 16 x 256
              tokens, AdamW, NCCL at world size 1): 8 fedavg steps (the
              loss falls), 2 trimmed_mean and 2 krum, K1-K3 once a step;
              scan bitwise python under deterministic algorithms; the
              replayed step timed and traced; step 1 at 2 layers against
              the CPU port (a swapped client outside it); and K1, K2
              (three modes) and K3 on the (1, 4, 1,385,219,072) grads
              buffer (rows 2-3 past 2^31 and 2^32 elements): each row's
              last 4,096 columns against the plain versions, then random
              on the whole, K2 against its plain version and K1's sums and
              K3's Gram against fp64 sums, timed beside bound and library.
              Its launches join the kernels line, each path's read right
              after the reset that precedes it (``blocks_launches``: {path:
              n}); K8's and K9's entries carry the new shapes as
              ``blocks``, K1-K3's the granite buffer as ``granite_pod``.
              granite's replayed step is timed and traced from the fedavg
              run's final state.
  11. tp      the pod step on a placed state (``pod.place_state``: params
              and AdamW moments as DTensors by a ``sharding/specs.py``
              layout) at mesh (1, 1), NCCL at world size 1, in a child
              process (``python3 chip_smoke.py --tp`` runs it alone).
              tiny-lm at full width (C = 4, 16 x 256 tokens, AdamW): step
              1 under ``param_specs`` with ``robust=None`` and with
              per_client fedavg and trimmed_mean (K1 and its K2 mode once
              each; the launches join the kernels line as
              ``tp_launches``) against the same step on plain tensors,
              the params within TP_REL of the largest param change
              (bitwise or not, printed); ZeRO-1 (``param_specs_tp``
              compute in bf16, ``param_specs`` master): step-1 loss within
              ZERO1_LOSS_ATOL of the fp32 step's, grad_norm within
              ZERO1_GN_REL of that step's (relative), the loss falling over
              TP_STEPS steps, grad_norm finite; scan bitwise python on both
              layouts under deterministic algorithms (TP_PARITY); the
              placed step's wall (median of 10), busy, idle, launches,
              tokens/s and peak under both drivers, for both layouts and
              for the same step on plain tensors (what placing costs on
              the host).
              Every step 1 runs under deterministic algorithms.
              granite-moe-1b at full depth, ``robust=None``: step 1 under
              ``param_specs_moe_ff`` against plain tensors, ZeRO-1 under
              ``param_specs_zero1_moe`` / ``param_specs_moe_ff`` against
              the fp32 step, TP_GRANITE_STEPS steps of each timed, peak;
              and the placed MoE's combine of a rank's slots
              (``moe._slot_combine``, which mesh (1, 1) does not take) over
              TP_SLOT_BLOCKS blocks at granite's width against the plain
              combine, within TP_SLOT_REL.
  12. dryrun  the dry-run of the sharded step (``launch/dryrun.py``): the
              step run once on fake tensors over a fake process group of
              256 (512) ranks, counted per chip (flops, bytes, collective
              bytes by kind, peak of live storage) and turned into the
              roofline's modeled seconds with the H100's constants; nothing
              in it runs on the card or launches a kernel.  A child process
              (``--dryrun fake``, started before phase 11, joined here)
              prints qwen2.5-14b x train_4k at 16 x 16, dbrx x train_4k
              under ``perf.measure(..., "zero1_moe")``, minitron-4b x
              decode_32k under ``tp_serve`` and at 2 x 16 x 16, one JSON
              line each, and the anchors' dry-runs at mesh (1, 1).
              A second child (``--dryrun card``) runs the anchors for real
              on the card under the same counter: tiny-lm and granite at
              full depth on phase 11's configuration (``robust=None``,
              placed by ``param_specs`` at mesh (1, 1), NCCL): counted
              flops equal the dry-run's exactly, both count 0 collective
              bytes, the dry-run's peak within DRYRUN_PEAK_REL of
              ``max_memory_allocated``; the replayed step's ms printed
              against the dry-run's ``bound_s``.  granite's placed step
              with ``remat`` on and off (step 1 bitwise under
              deterministic algorithms; peak GB and step ms both ways),
              tiny-lm with ``remat`` replayed bitwise its python loop, and
              minitron-4b's prefill and decode on ``param_specs_tp`` params
              and a placed cache bitwise the plain call.  Both children
              count zero kernel launches; their counts, summed by kernel,
              are each kernel's ``dryrun_launches``.
  13. lint    the static analysis (``python -m repro_torch.analysis.lint
              --all``) over its 14 entry points, in two child processes:
              ``--device cpu`` (started before phase 11, beside it and
              phase 12, joined here) and ``--device cuda`` (a child that
              takes the card and loads the kernels beside phase 12 and
              runs the linter after it, LINT_TIMEOUT).  Prints each
              entry's status, its kernel launches by counter against the
              launches it expects, each kernel's shared memory a block
              against the card's opt-in limit, and the phase's seconds.
              Fails on an error finding on either device, on an entry
              whose set of (rule, severity) findings differs between the
              two (notes, which hold what only the card checks, are not
              compared), and on an entry expected to launch a kernel that
              launched none.  The card's launches,
              summed by kernel, are each kernel's ``lint_launches``.
The last three lines are the nvidia-smi line, the kernels JSON and the
result JSON.  ``python3 chip_smoke.py --lint`` runs phase 13 alone.
``python3 chip_smoke.py --kernels`` runs phases 1, 2, 2b and
2c alone and ends with the nvidia-smi line and the kernels JSON (launches
null), with no result line: the quick check of the kernels, and the way to
time a parent commit's kernels (that commit's own script, run from a
``git archive`` of it).  Without a CUDA device, or without the
repository's src/repro_torch beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM data-sheet peaks: HBM bytes/s, fp32 FLOP/s outside the tensor
# cores and dense bf16 FLOP/s on them
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# tolerances, kernel vs plain version on the same card.  The median picks
# entries, so it is bitwise.  Per-column sums over C clients (mean,
# trimmed) keep the tests' rtol 1e-5 / atol 1e-6.  Sums over N columns
# (cosine partials, Gram) reduce ~4e5 terms in other orders, so they are
# held at 1e-5 of the largest magnitude.
RTOL, ATOL = 1e-5, 1e-6
NSUM_REL = 1e-5
# round 1 on the card vs on the CPU: conv and matmul in other orders
ROUND1_ATOL = 1e-5

TIMED_CALLS = 20
SLICE_SHAPE = (1, 16, 421_642)
WIDE_SHAPE = (2, 64, 65_573)
QBLK = 128
# paper-cnn's wire record under int8: 421,642 codes + 3,297 fp32 scales
INT8_BYTES_PER_CLIENT = 434_830
WIDE_LEAVES = (1000, 33, 64_000, 540)          # ragged leaves of WIDE_SHAPE
TPU_KERNELS = {   # name -> (file:line of the Pallas kernel it replaces)
    "cosine_gate_partials":
        "src/repro/kernels/robust_pipeline.py:280",
    "gated_combine": "src/repro/kernels/robust_pipeline.py:398",
    "pairwise_gram": "src/repro/kernels/robust_pipeline.py:494",
    "dequant_gate_partials": "src/repro/comm/kernels/comm_codecs.py:125",
    "dequant_gated_combine": "src/repro/comm/kernels/comm_codecs.py:188",
    "dequant_pairwise_gram": "src/repro/comm/kernels/comm_codecs.py:248",
    "robust_agg_fwd": "src/repro/kernels/robust_agg.py:70",
    "cosine_gate_partials_flat": "src/repro/kernels/robust_pipeline.py:219",
    "gated_combine_flat": "src/repro/kernels/robust_pipeline.py:351",
    "pairwise_sq_dists_blocked": "src/repro/kernels/robust_pipeline.py:447",
}
FLAT_OF = {"cosine_gate_partials_flat": "cosine_gate_partials",
           "gated_combine_flat": "gated_combine",
           "pairwise_sq_dists_blocked": "pairwise_gram"}
DEQUANT_OF = {"dequant_gate_partials": "cosine_gate_partials",
              "dequant_gated_combine": "gated_combine",
              "dequant_pairwise_gram": "pairwise_gram"}
CUDA_SOURCE = "src/repro_torch/csrc/robust_pipeline.cu"
CUDA_SOURCE_K6 = "src/repro_torch/csrc/comm_codecs.cu"
CUDA_SOURCE_K7 = "src/repro_torch/csrc/population_select.cu"
CUDA_SOURCE_K5 = "src/repro_torch/csrc/robust_agg.cu"
GRAM_WIDE_SHAPE = (1, 96, 65_573)          # K3 / K6c past one 32-row tile
# the earlier designs' times, as PERF.md section 6 records them (NVIDIA H100
# 80GB HBM3, 700 W): K3 / K6c at GRAM_WIDE_SHAPE and K3 at SLICE_SHAPE on 64 x
# 64 tiles of one output a thread, K9 at phase 2c's timed shape on the FMA
# units
GRAM_BEFORE_MS = {"pairwise_gram": 0.5213, "dequant_pairwise_gram": 0.7220,
                  "pairwise_gram C=16": 0.0707}
K9_BEFORE_MS = {0: 1.0381, 256: 0.4915}
# K8 at phase 2c's timed shape (fp32 / int8 pools) and K2's three modes at
# SLICE_SHAPE (ranges over several runs) before the register designs, as
# PERF.md section 6 records them (NVIDIA H100 80GB HBM3, 700 W)
K8_BEFORE_MS = {"paged_flash_decode": 0.0703,
                "paged_flash_decode[int8]": 0.0976}
K2_BEFORE_MS = {"mean": "0.0292-0.0437", "trimmed": "0.0678-0.0694",
                "median": "0.0670-0.0734"}
# K1 / K4a / K6a at SLICE_SHAPE and K1 at ASYNC_K1_SHAPE on the shared-tile
# design, device only (torch.profiler), as PERF.md section 6 records them
# (NVIDIA H100 80GB HBM3, 700 W)
K1_BEFORE_MS = {"cosine_gate_partials": "0.0881-0.0882",
                "cosine_gate_partials_flat": "0.0795-0.0880",
                "dequant_gate_partials": "0.0930-0.0931",
                "cosine_gate_partials C=48": "0.6021-0.6024"}
# rows whose device-only time (torch.profiler) phase 2 also records: the
# pass-1 body and K2's in each of their entry points
DEVICE_TIMED = ("gated_combine", "dequant_gated_combine", "robust_agg_fwd",
                "gated_combine_flat", "cosine_gate_partials",
                "cosine_gate_partials_flat", "dequant_gate_partials")
# pass 1 at the async path's C + B = 48 rows
ASYNC_K1_SHAPE = (1, 48, 421_642)
# pass 1's checks: C on both sides of each register bucket's edge and past
# 64 rows (the shared tile)
PASS1_EDGES = (1, 16, 17, 32, 33, 48, 64, 65, 130)
HOST_CALLS = 1000
K7_REPLACES = "src/repro/kernels/population_select.py:98"
# (M, d) timed in phase 2b: the async path's shape first, then the
# reference's bench shapes (benchmarks/bench_kernels.py)
TOPD_TIMED = ((16_384, 16), (100_000, 64), (1_000_000, 64))
# the earlier design's K7 (stage 1: d rounds of max-and-mask a block) and
# K7 + merge (the -inf padding copy, K7, a stable sort, a gather) at
# TOPD_TIMED, device only (torch.profiler), as PERF.md section 6 records them
# (NVIDIA H100 80GB HBM3, 700 W)
K7_BEFORE_MS = {(16_384, 16): ("0.0109", "0.0214"),
                (100_000, 64): ("0.0389-0.0400", "0.0668-0.0671"),
                (1_000_000, 64): ("0.0538-0.0557", "0.1065-0.1078")}
# (M, d) of K7's global path timed in phase 2b: cohorts past the shared-
# memory budget (blk = d > 16,384)
TOPD_LARGE_TIMED = ((100_000, 16_385), (100_000, 20_000))
# phase 5: the buffered-async engine at full width
ASYNC_M, ASYNC_N, ASYNC_C = 16_384, 131_072, 16
ASYNC_SCHEDULE = (("trimmed_mean", 8), ("fedavg", 2), ("median", 2),
                  ("krum", 2))
DENSE_BYTES_PER_CLIENT = 1_686_568          # paper-cnn's 421,642 fp32
# phase 6b: registry cells at paper-cnn width ("+partial0.1": the cell with
# partial_min_frac=0.1, "+gate0": with cosine_outlier_thresh=0,
# "+retries4": with async_max_retries=4)
ROBUST_CELLS = ("alie_trimmed", "minmax_trimmed", "gate_aware_krum",
                "backdoor_trimmed", "cross_round_trimmed", "signflip_fedfits",
                "signflip_fedfits+gate0", "hetero_fedfits",
                "hetero_fedfits+partial0.1", "gate_aware_int8_dropout",
                "async_late_poison_krum+retries4")
REPLAY_CELLS = ("hetero_fedfits", "gate_aware_int8_dropout",
                "async_late_poison_krum+retries4")
ROBUST_ROUNDS, ROBUST_K = 6, 16
# phase 5b: driver="scan" against driver="python" on the card, bitwise
# under cuDNN's deterministic algorithms.  Under its defaults the conv's
# backward does not repeat: two runs of the per-round loop differ by
# 3.6e-7 to 1.3e-6 over 7 fp32 rounds, scan from the loop by up to 8.9e-6
# (PERF.md section 6), so there the masks must be equal and the rest within
# PARITY_DEFAULT_ATOL
PARITY_ROUNDS, PARITY_CHUNK = 7, 3          # a partial chunk at the end
PARITY_AGGS = ("fedavg", "trimmed_mean", "krum")
PARITY_CELL = "hetero_fedfits+gaussian"     # a noisy attack and faults
PARITY_DEFAULT_ATOL = 1e-4
MASK_KEYS = ("team", "h_next", "avail", "lost", "gated", "eff_epochs",
             "cohort", "on_time", "due", "exhausted")
SERVE_PARITY_STEPS = 10
DEVICE = "cuda"
# phases 2c, 7, 8: K8, K9, serving and the full forward on minitron-4b
K8_SOURCE = "src/repro_torch/csrc/paged_decode.cu"
K9_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
K8_REPLACES = "src/repro/kernels/paged_decode.py:98"
K9_REPLACES = "src/repro/kernels/flash_attention.py:82"
SERVE_ARCH = "minitron-4b"
SERVE_SLOTS, SERVE_PAGE, SERVE_MAXP, SERVE_PROMPT = 16, 16, 24, 128
SERVE_CFG = dict(max_slots=SERVE_SLOTS, page_size=SERVE_PAGE,
                 max_len=SERVE_PAGE * SERVE_MAXP, prompt_pad=SERVE_PROMPT)
SUB_SLOTS = 8
SUB_CFG = dict(SERVE_CFG, max_slots=SUB_SLOTS)
FWD_SEQ, FWD_WINDOW = 1024, 256
# K8 against its plain version: fp32 sums over up to 384 keys in other
# chunkings (the tests' bound).  K9: the same tiles and order of tiles, the
# dot products summed in another order: fp32 within 1e-5, bf16 within one
# bf16 ulp of the output plus that.
K8_ATOL, K9_ATOL = 2e-5, 1e-5
# bf16 model paths that differ only in the attention kernel, as a share of
# the largest value, set from readings on the H100 (PERF.md): first-step
# logits 0.0141-0.0144 sound, 0.060 and 0.42 under the two paging faults;
# the forward's last hidden state 0.0274 sound, 0.208 with a key block
# dropped
SERVE_LOGIT_REL = 2.0 ** -5
FWD_HIDDEN_REL = 2.0 ** -4
# fp32 prefill + decode steps against the full forward at the same
# position, as a share of the step's largest logit: the same sums in other
# orders (chunked scans against one-step recurrences, a ring against the
# band) through up to 48 layers
DECODE_FP32_REL = 1e-3
# xlstm-350m's 7:1 pattern in fp32 at a 4-token prompt: its sLSTM at the
# random init amplifies rounding ~1.2x a step (on the H100 16 decode steps
# drift 1.8e-4 -> 3.3e-3, and a 1,024-token prompt reads 1.1), so its
# steps are held at the bf16 bound; a state carried wrong moves them O(1)
XL_SLSTM_PROMPT, XL_SLSTM_REL = 4, 2.0 ** -5
# fp32 paths: 2 layers of full-width matmuls (sums over 3,072 and 9,216
# terms) in other orders
FWD_FP32_ATOL = 1e-4
ROUND1_LOGIT_REL = 1e-4


# phase 9: the pod trainer (core/pod.py through launch/train.py) at tiny-lm's
# full width, 64,233,984 fp32 parameters: C = 4 clients, a global batch of
# 16 sequences of 256 tokens, AdamW; (aggregator, codec, steps) of each run
# of the entry point, in order
POD_ARCH, POD_C, POD_GB, POD_SEQ = "tiny-lm", 4, 16, 256
POD_SCHEDULE = (("fedavg", "none", 20), ("trimmed_mean", "none", 2),
                ("median", "none", 2), ("krum", "none", 2),
                ("fedavg", "int8", 4), ("krum", "int8", 2))
POD_SHAPE = (1, POD_C, 64_233_984)          # K1-K3 / K6 on the pod path
POD_PARITY = (6, 2)             # scan vs python: steps, chunk
POD_CKPT = (8, 4)               # the resume check: steps, checkpoint at
# step 1 on the card against the CPU port: full width, 2 layers, SGD.  The
# aggregated, clipped grads (SGD's momentum after one step), as a share of
# their largest: fp32 forward and backward sums over up to 32,000 terms in
# other orders
POD_CPU_LAYERS, POD_CPU_REL = 2, 1e-4
POD_TIMEOUT = 900               # seconds for the phase's child process

# phase 10: the other block kinds at their published widths.  granite at
# full depth, served (GRANITE_REQS requests, generations in GRANITE_GEN) and
# trained through launch/train.py (C = 4, 16 x 256 tokens a step; the
# schedule's (aggregator, steps), in chunks of GRANITE_CHUNK; scan vs python
# over GRANITE_PARITY's (steps, chunk)); K1-K3 on its (1, 4, N) grads
# buffer, checked on each row's last TAIL_COLS columns.  hymba, xlstm and
# musicgen at full depth; dbrx cut to DBRX_LAYERS layers and
# llama-3.2-vision to one cycle of VISION_LAYERS (4 attn + 1 xattn)
GRANITE = "granite-moe-1b-a400m"
GRANITE_PARAMS = 1_385_219_072
GRANITE_REQS, GRANITE_GEN = 24, (16, 128)
GRANITE_SCHEDULE = (("fedavg", 8), ("trimmed_mean", 2), ("krum", 2))
GRANITE_CHUNK = 4
GRANITE_PARITY = (3, 2)
GRANITE_SHAPE = (1, POD_C, GRANITE_PARAMS)
TAIL_COLS = 4096
WHOLE_CHUNK = 1 << 24           # columns a step of the checks on the whole
HYMBA, XLSTM, MUSICGEN = "hymba-1.5b", "xlstm-350m", "musicgen-large"
HYMBA_SEQ, HYMBA_PREFILL, HYMBA_DECODE = 2048, 1100, 64
XL_SEQ, XL_DECODE = 1024, 16
DBRX, DBRX_LAYERS = "dbrx-132b", 2
VISION, VISION_LAYERS = "llama-3.2-vision-90b", 5
CUT_SEQ, CUT_DECODE = 512, 4    # the depth-cut models: forward length,
                                # decode steps
# the CPU-port checks: full width, 2 layers, (2, BLK_CPU_SEQ) inputs
BLK_CPU_LAYERS, BLK_CPU_SEQ = 2, 16
# K8 at each served model's (Hq, Hkv, dh): GQA groups 2, 6 and 1
K8_BLOCKS = {GRANITE: (16, 8, 64), DBRX: (48, 8, 128),
             MUSICGEN: (32, 32, 64)}
# K9 at each forward's heads: the sequence length it runs at
K9_BLOCKS = {HYMBA: HYMBA_SEQ, DBRX: CUT_SEQ, VISION: CUT_SEQ,
             MUSICGEN: XL_SEQ}
BLOCKS_TIMEOUT = 900            # seconds for the phase's child process

# phase 11: the pod step on a placed state (sharding/specs.py's layouts as
# DTensors, NCCL at world size 1, mesh (1, 1)).  tiny-lm at full width
# (POD_ARCH, POD_C, POD_GB x POD_SEQ, AdamW): step 1 of each placed path
# against the same step on plain tensors, the params within TP_REL of the
# largest param change; ZeRO-1's step-1 loss within ZERO1_LOSS_ATOL (the
# reference test's tolerance) of the fp32 step's, its loss falling over
# TP_STEPS steps; scan vs python over TP_PARITY (steps, chunk).  granite at
# full depth, TP_GRANITE_STEPS steps under each MoE layout (the placed MoE:
# the routing keys gathered, each rank's slots filled and combined, the
# partial sums reduced).  The padded heads of an uneven split: tiny-lm's
# first attention layer on params placed at mesh (1, 1), run in its heads
# padded as a split over TP_PAD_PIECES ranks pads them, against the same
# call in its own heads (output and grads within TP_PAD_REL of their
# largest).  The placed MoE's combine of a rank's slots (``moe._slot_combine``,
# which a mesh of one rank does not take) at granite's width on the
# (POD_GB x POD_SEQ) tokens, over TP_SLOT_BLOCKS blocks of the (E, C)
# slots summed, against the plain ``moe._combine``: the output and the
# expert rows' grad within TP_SLOT_REL of their largest
TP_REL = 1e-6
TP_PAD_PIECES, TP_PAD_REL = 3, 1e-5
TP_SLOT_BLOCKS, TP_SLOT_REL = (4, 4), 1e-5
ZERO1_LOSS_ATOL = 0.05
ZERO1_GN_REL = 1e-2             # ZeRO-1's step-1 grad_norm against fp32's
TP_STEPS = 6
TP_PARITY = (4, 2)
TP_GRANITE_STEPS = 3
TP_TIMEOUT = 900                # seconds for the phase's child process

# phase 12: the dry-run (launch/dryrun.py, roofline.py, perf.py) on the
# card machine's torch, over a fake process group, in a child process
# started before phase 11 and joined here (it needs no card and runs beside
# phase 11's card work, after phase 10's CPU-port steps); the anchor:
# tiny-lm and granite at full depth on phase 11's configuration (C = 4, 16
# x 256 tokens, robust=None, mesh (1, 1)) both as a real step on the card
# and as its dry-run, the counted flops equal, no collective byte, the
# dry-run's peak within DRYRUN_PEAK_REL of the card's max_memory_allocated;
# granite's placed step with remat on and off (step 1 bitwise under
# deterministic algorithms; peak and step ms both ways); tiny-lm with remat
# replayed bitwise its python loop (TP_PARITY); minitron-4b's prefill of
# TP_SERVE_B x TP_SERVE_PROMPT tokens and TP_SERVE_DECODE decode steps on
# params placed by param_specs_tp and a placed cache, bitwise the plain
# call's logits
DRYRUN_PEAK_REL = 0.15
# the sharded step partitioned as the reference's partitions it (counts of
# the same dry-runs, not measurements): qwen2.5-14b x train_4k's flops at
# most DRYRUN_FLOPS_OVER_XLA x XLA's count of the reference's step (its
# dry-run, `python -m repro.launch.dryrun --arch qwen2.5-14b --shape
# train_4k`); a minitron-4b decode_32k step's all-gather at most 1/8 of the
# count of the step that gathered the sequence-split cache (tp_serve at 16 x
# 16, param_specs at 2 x 16 x 16)
DRYRUN_XLA_QWEN_FLOPS = 868_310_858_072_064
DRYRUN_FLOPS_OVER_XLA = 1.25
DRYRUN_SERVE_AG_MAX = {
    "minitron-4b x decode_32k tp_serve 16x16": 35_935_223_808 / 8,
    "minitron-4b x decode_32k 2x16x16": 18_875_154_432 / 8}
DRYRUN_QWEN = ("qwen2.5-14b", "train_4k")
DRYRUN_PERF = ("dbrx", "zero1_moe")
DRYRUN_SERVE = ("minitron-4b", "decode_32k")
DRYRUN_ANCHORS = (POD_ARCH, GRANITE)
ANCHOR_CHUNK, ANCHOR_CHUNKS = 2, 2      # the replayed steps: chunk, chunks
TP_SERVE_B, TP_SERVE_PROMPT, TP_SERVE_DECODE = 2, 64, 2
DRYRUN_TIMEOUT = 600            # seconds for each of the phase's children

# phase 13: the static analysis over its entry points, on the CPU (beside
# phases 11-12) and on the card
LINT_TIMEOUT = 180              # seconds for each of the phase's children
LINT_ENTRIES = 14


def bound(bytes_moved, ops, ops_per_s=FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and the
    operations over the peak rate of the inputs' type (fp32 unless given)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_work(name, g, c, n, mode=None, nq=0, n_leaves=0):
    """Bytes each kernel must move (inputs read once, outputs written once)
    and the operations it does: C^2 compares per column for the rank
    network, 2 flops per multiply-add; the Gram X X^T is symmetric, so it
    needs C(C+1)/2 multiply-adds per column.  A fused-dequant kernel reads one
    byte a code, the (G, C, nq) fp32 scales, its mask and the leaf table
    in place of the fp32 matrix, and adds one multiply a code."""
    x, deq = 4 * g * c * n, 0
    name = FLAT_OF.get(name, name)
    if name == "robust_agg_fwd":               # x, the team mask, the row
        return x + 4 * g * c + 4 * g * n, g * n * (c * c + 2 * c)
    if name in DEQUANT_OF:
        name = DEQUANT_OF[name]
        x = g * c * n + 4 * g * c * nq + 4 * (2 * n_leaves + 2)
        deq = g * c * n
        if name == "pairwise_gram":
            x += 4 * g * c                         # the mask
    if name == "cosine_gate_partials":
        return x + 4 * g * c + 4 * g * (2 * c + 1), \
            g * n * (c * c + 4 * c + 2) + deq
    if name == "pairwise_gram":
        return x + 4 * g * c * c, g * c * (c + 1) * n + deq
    ops = 2 * g * c * n if mode == "mean" else g * n * (c * c + 2 * c)
    return x + 8 * g * c + 4 * g * n, ops + deq


def topd_work(m, d):
    """Bytes and operations of the top-d of M keys: each key read once, the
    d indices written; one compare per key."""
    return 4 * m + 4 * d, m


def time_ms(fn):
    """Mean device time of one call by CUDA events, after a warm-up.  The
    (C, N) matrix stays in L2 between calls, as it does in the round,
    where the guard has just read it."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(TIMED_CALLS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / TIMED_CALLS


def device_ms(fn, calls=10):
    """Mean device time of one call, the kernels' own time by
    torch.profiler: free of the host's launch gaps, which CUDA events
    around back-to-back calls count when a wrapper's host work outlasts
    its kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):              # a trace that caught no kernel is retaken
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            break
    return total / calls / 1e3


def host_us(fn, calls=HOST_CALLS):
    """Host time of one wrapper call in microseconds: ``calls`` calls back
    to back with no synchronize between them (the launches queue on the
    device), then one synchronize outside the timed loop."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / calls


def _import_port():
    if not (SRC / "repro_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py: src/repro_torch not found beside "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, str(SRC))


def _smi():
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _card():
    import torch
    smi = _smi()
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    regs = [l.strip() for l in _build.build_log().splitlines()
            if "registers" in l]
    print(f"[card] {smi} | {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | kernels built in "
          f"{time.perf_counter() - t0:.1f} s")
    for r in regs:
        print(f"[card] ptxas {r}")
    for name, info in ptxas_report(_build.build_log()).items():
        print(f"[card] ptxas {name}: {info}")
    return smi


def _kernel_name(mangled):
    """'fa_mma_kernel<2>', 'gram_partials<32, QuantRows>',
    'combine_ranks<DenseRows, 16, 2, C == B>' (bucket, columns a thread),
    'pass1_ranks<QuantRows, 16, 2, vector>' (bucket, columns a thread,
    loads), 'pass1_partials<DenseRows>' (pass 1's shared tile, past 64
    rows), 'pd_kernel<3, 4, 1, int8>' (row block, vector width, vectors a
    lane, pool) for the register and tensor-core bodies' mangled names,
    'block_topd_kernel' for K7's, else None."""
    import re
    if "block_topd_kernel" in mangled:
        return "block_topd_kernel"
    m = re.search(r"(fa_mma_kernel|gram_partials|combine_mean|combine_ranks"
                  r"|pass1_ranks|pass1_partials|pd_kernel)I(\w+?)EEv",
                  mangled)
    if not m:
        return None
    flag = {"pd_kernel": ("fp32", "int8"),              # the pool type
            "combine_ranks": ("C < B", "C == B"),
            "pass1_ranks": ("scalar", "vector")}.get(m.group(1), ("0", "1"))
    args = [t.group(1) or (flag[int(t.group(0)[2])] if t.group(0)[:2] == "Lb"
                           else t.group(0))
            for t in re.finditer(r"Li(\d+)E|DenseRows|QuantRows|Lb[01]",
                                 m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas_report(log):
    """{kernel: "R registers, S B spill stores, L B spill loads[; note]"}
    for the bodies ``_kernel_name`` names, from nvcc's -Xptxas -v output (a
    note where ptxas serialized wgmma)."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            if name:
                out.setdefault(name, {})
            continue
        m = re.search(r"Performance Loss: (.*?) for the function '(\S+)'",
                      line)
        if m and _kernel_name(m.group(2)):
            out.setdefault(_kernel_name(m.group(2)), {})["note"] = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].setdefault("spills", m.group(1, 2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name].setdefault("regs", m.group(1))
    return {k: f"{v.get('regs')} registers, {v.get('spills', ('?',))[0]} B "
               f"spill stores, {v.get('spills', ('?', '?'))[1]} B spill loads"
               + (f"; {v['note']}" if "note" in v else "")
            for k, v in sorted(out.items())}


def _check(name, out, ref, exact=False, rel=None):
    import torch
    err = float((out - ref).abs().max())
    if exact:
        ok = torch.equal(out, ref)
    elif rel is not None:
        ok = err <= rel * float(ref.abs().max())
    else:
        ok = bool(torch.allclose(out, ref, rtol=RTOL, atol=ATOL))
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


def _inputs(shape, seed, masks):
    import numpy as np
    import torch
    g, c, n = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape, np.float32) * 1e-2)
    mask = torch.from_numpy(np.asarray(masks, np.float32))
    w = torch.from_numpy(rng.uniform(0.1, 1.0, (g, c)).astype(np.float32))
    w = w * mask
    w = w / w.sum(1, keepdim=True).clamp(min=1e-12)
    return x.cuda(), mask.cuda(), w.cuda()


def _bitwise(name, out, ref, what="K1-K3 on the masked decode"):
    """Bitwise equality, NaN equal to NaN."""
    import torch
    same = (out.view(torch.int32) == ref.view(torch.int32)) \
        | (out.isnan() & ref.isnan())
    if not bool(same.all()):
        raise AssertionError(f"{name}: not bitwise equal to {what}")


def _encode(x, sizes):
    """int8 codes (G, C, N) and scales (G, C, NQ) of x by the port's own
    codec, over leaves of the given sizes."""
    from repro_torch.comm import codecs
    g, c, n = x.shape
    layout = codecs.WireLayout(sizes, QBLK)
    enc = codecs.Codec("int8", qblk=QBLK).encode_flat(x.reshape(g * c, n),
                                                      layout)
    return enc.q.view(g, c, n), enc.s.view(g, c, -1), layout


def _dequant_checks(label, x, m, w, sizes, errs):
    """K6a-c against their plain versions, and bitwise against K1-K3 on
    the masked decode where(m, q * s, 0)."""
    from repro_torch.comm.kernels import comm_codecs as cc
    from repro_torch.kernels import robust_pipeline as rp
    q, s, layout = _encode(x, sizes)
    xm = cc.dequant_masked(q, s, layout, m)

    def note(key, e):
        errs[key] = max(errs.get(key, 0.0), e)

    outs = cc.dequant_gate_partials(q, s, layout, m)
    plain = cc.dequant_gate_partials_plain(q, s, layout, m)
    for part, o, p, d in zip(("dots", "sqnorms", "refsq"), outs, plain,
                             rp.cosine_gate_partials(xm, m)):
        key = "dequant_gate_partials"
        note(key, _check(f"{key}/{part} {label}", o, p, rel=NSUM_REL))
        _bitwise(f"{key}/{part} {label}", o, d)
    for mode in rp.MODES:
        key = f"dequant_gated_combine[{mode}]"
        o = cc.dequant_gated_combine(q, s, layout, m, w, mode=mode)
        p = cc.dequant_gated_combine_plain(q, s, layout, m, w, mode=mode)
        note(key, _check(f"{key} {label}", o, p, exact=mode == "median"))
        _bitwise(f"{key} {label}", o, rp.gated_combine(xm, m, w, mode=mode))
    key = "dequant_pairwise_gram"
    o = cc.dequant_pairwise_gram(q, s, layout, m)
    note(key, _check(f"{key} {label}", o,
                     cc.dequant_pairwise_gram_plain(q, s, layout, m),
                     rel=NSUM_REL))
    _bitwise(f"{key} {label}", o, rp.pairwise_gram(xm))


def _inf_scale_check(masks):
    """A masked-out client whose scales are inf (a non-finite update): the
    partials of the masked-in rows, refsq, every combine, Krum's masked-in
    distances and the four aggregates stay finite."""
    import torch
    from repro_torch.comm.kernels import comm_codecs as cc
    from repro_torch.kernels import robust_pipeline as rp
    x, m, w = _inputs(WIDE_SHAPE, 7, masks)
    q, s, layout = _encode(x, WIDE_LEAVES)
    out = m == 0
    s[out] = float("inf")
    keep = m > 0
    dots, sqn, refsq = cc.dequant_gate_partials(q, s, layout, m)
    vals = [dots[keep], sqn[keep], refsq]
    vals += [cc.dequant_gated_combine(q, s, layout, m, w, mode=mode)
             for mode in rp.MODES]
    d = rp.sq_dists_from_gram(cc.dequant_pairwise_gram(q, s, layout, m), m)
    vals.append(d[keep[:, :, None] & keep[:, None, :]])
    vals += [cc.fused_dequant_pipeline(q, s, layout, w, m, aggregator=a)
             for a in ("fedavg", "trimmed_mean", "median", "krum")]
    if not all(bool(torch.isfinite(v).all()) for v in vals):
        raise AssertionError("a masked-out client with inf scales made a "
                             "fused-dequant output non-finite")
    print(f"[kernels] {WIDE_SHAPE} inf scales on {int(out.sum())} masked-out "
          "rows: partials, combines, Krum distances and aggregates finite")


def _kernels(cnn_sizes):
    """Phase 2: every kernel against its plain version (K6 also against
    K1-K3); returns the report entries (times at the main path's shape)."""
    import torch
    from repro_torch.comm.kernels import comm_codecs as cc
    from repro_torch.kernels import robust_pipeline as rp

    g, c, n = WIDE_SHAPE
    normal = [1.0] * c
    normal[5] = 0.0
    lone = [0.0] * c
    lone[7] = 1.0
    cases = [(SLICE_SHAPE, [[1.0] * SLICE_SHAPE[1]]),
             (WIDE_SHAPE, [normal, [0.0] * c]),       # empty cohort
             (WIDE_SHAPE, [lone, normal])]            # one-member cohort
    errs = {}
    for shape, masks in cases:
        x, m, w = _inputs(shape, sum(shape), masks)
        outs = rp.cosine_gate_partials(x, m)
        refs = rp.cosine_gate_partials_plain(x, m)
        for part, o, r in zip(("dots", "sqnorms", "refsq"), outs, refs):
            e = _check(f"cosine_gate_partials/{part} {shape}", o, r,
                       rel=NSUM_REL)
            errs["cosine_gate_partials"] = max(
                errs.get("cosine_gate_partials", 0.0), e)
        for mode in rp.MODES:
            o = rp.gated_combine(x, m, w, mode=mode)
            r = rp.gated_combine_plain(x, m, w, mode=mode)
            key = f"gated_combine[{mode}]"
            errs[key] = max(errs.get(key, 0.0), _check(
                f"{key} {shape}", o, r, exact=mode == "median"))
            if len(masks) == 2 and masks[1] == [0.0] * c \
                    and float(o[1].abs().max()) != 0.0:
                raise AssertionError(f"{key}: empty cohort is not zero")
            if masks[0] == lone:
                _check(f"{key} lone", o[0], x[0, 7], exact=mode == "median")
        e = _check(f"pairwise_gram {shape}", rp.pairwise_gram(x),
                   rp.pairwise_gram_plain(x), rel=NSUM_REL)
        errs["pairwise_gram"] = max(errs.get("pairwise_gram", 0.0), e)
        sizes = cnn_sizes if shape == SLICE_SHAPE else WIDE_LEAVES
        _dequant_checks(str(shape), x, m, w, sizes, errs)
        torch.cuda.synchronize()
        print(f"[kernels] {shape} masks={[int(sum(r)) for r in masks]}: "
              "all kernels agree with their plain versions; K6a-c on "
              f"{len(sizes)} leaves are bitwise K1-K3 on the masked decode")
    _inf_scale_check([normal, normal])
    _pass1_checks(errs)

    g, c, n = SLICE_SHAPE
    x, m, w = _inputs(SLICE_SHAPE, 0, [[1.0] * c])
    q, s, layout = _encode(x, cnn_sizes)
    calls = {
        "cosine_gate_partials": (
            lambda: rp.cosine_gate_partials(x, m),
            lambda: rp.cosine_gate_partials_plain(x, m), None),
        "gated_combine[mean]": (
            lambda: rp.gated_combine(x, m, w, mode="mean"),
            lambda: rp.gated_combine_plain(x, m, w, mode="mean"),
            lambda: torch.matmul(w[:, None, :], x)),
        "gated_combine[trimmed]": (
            lambda: rp.gated_combine(x, m, m, mode="trimmed"),
            lambda: rp.gated_combine_plain(x, m, m, mode="trimmed"), None),
        "gated_combine[median]": (
            lambda: rp.gated_combine(x, m, m, mode="median"),
            lambda: rp.gated_combine_plain(x, m, m, mode="median"),
            lambda: torch.quantile(x, 0.5, dim=1)),
        "pairwise_gram": (
            lambda: rp.pairwise_gram(x),
            lambda: rp.pairwise_gram_plain(x),
            lambda: torch.bmm(x, x.transpose(1, 2))),
        "dequant_gate_partials": (
            lambda: cc.dequant_gate_partials(q, s, layout, m),
            lambda: cc.dequant_gate_partials_plain(q, s, layout, m), None),
        "dequant_pairwise_gram": (
            lambda: cc.dequant_pairwise_gram(q, s, layout, m),
            lambda: cc.dequant_pairwise_gram_plain(q, s, layout, m), None),
    }
    for mode, wm in (("mean", w), ("trimmed", m), ("median", m)):
        calls[f"dequant_gated_combine[{mode}]"] = (
            lambda mode=mode, wm=wm: cc.dequant_gated_combine(
                q, s, layout, m, wm, mode=mode),
            lambda mode=mode, wm=wm: cc.dequant_gated_combine_plain(
                q, s, layout, m, wm, mode=mode), None)
    report = [_timed_entry(name, CUDA_SOURCE_K6 if name.partition("[")[0]
                           in DEQUANT_OF else CUDA_SOURCE, SLICE_SHAPE,
                           errs[name], kern, plain, lib, nq=layout.n_scales,
                           n_leaves=len(cnn_sizes))
              for name, (kern, plain, lib) in calls.items()]
    mean = next(e for e in report if e["name"] == "gated_combine[mean]")
    mean["host_us"] = host_us(calls["gated_combine[mean]"][0])
    print(f"[kernels] gated_combine[mean] wrapper: {mean['host_us']:.2f} us "
          f"of host time a call ({HOST_CALLS} calls, no synchronize)")
    k1 = next(e for e in report if e["name"] == "cosine_gate_partials")
    k1["c48"] = _pass1_c48()
    k3 = next(e for e in report if e["name"] == "pairwise_gram")
    kern, _, lib = calls["pairwise_gram"]
    k3["device_ms"], k3["library_device_ms"] = device_ms(kern), device_ms(lib)
    before = GRAM_BEFORE_MS["pairwise_gram C=16"]
    print(f"[kernels] pairwise_gram {SLICE_SHAPE}: {k3['ms']:.4f} ms against "
          f"the earlier design's {before} ms ({before / k3['ms']:.1f}x); "
          f"device "
          f"{k3['device_ms']:.4f} ms (bmm {k3['library_device_ms']:.4f})")
    return report


def _timed_entry(name, source, shape, err, kern, plain, lib, **work):
    """A kernels-line entry: CUDA-event times of the kernel, its plain
    version and the library call (if any) at ``shape``, and the bound.  A
    median's library call, ``torch.quantile(x, 0.5)``, interpolates halfway
    between the rows ranked floor((n-1)/2) and ceil((n-1)/2): under the
    full mask it computes the kernel's function, and is held to it."""
    g, c, n = shape
    base, _, mode = name.partition("[")
    if lib and mode == "median]":
        _check(f"torch.quantile(0.5) as {name} {shape}", lib(), kern(),
               rel=NSUM_REL)
    bound_ms, bound_by = bound(*kernel_work(base, g, c, n,
                                            mode.rstrip("]") or None, **work))
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": TPU_KERNELS[base], "launches": None,
             "max_abs_err": err, "ms": time_ms(kern),
             "plain_ms": time_ms(plain), "bound_ms": bound_ms,
             "bound_by": bound_by,
             "library_ms": time_ms(lib) if lib else None}
    print(f"[kernels] {name} {shape}: {entry['ms']:.4f} ms, plain "
          f"{entry['plain_ms']:.4f} ms, library {entry['library_ms']}, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    if base in DEVICE_TIMED:
        entry["device_ms"] = device_ms(kern)
        entry["library_device_ms"] = device_ms(lib) if lib else None
        print(f"[kernels] {name} {shape}: device {entry['device_ms']:.4f} ms "
              f"(library {entry['library_device_ms']}) against the earlier "
              f"design's {_before_ms(name)}")
    return entry


def _before_ms(name):
    """The earlier design's time of a DEVICE_TIMED row, as PERF.md
    records it."""
    base, _, mode = name.partition("[")
    if base in K1_BEFORE_MS:
        return f"{K1_BEFORE_MS[base]} ms device only"
    return f"{K2_BEFORE_MS[mode.rstrip(']')]} ms by events"


def _pass1_checks(errs):
    """Phase 2: pass 1 at C on both sides of each register bucket's edge
    and past 64 rows, N = 0-3 mod 4, aligned and not, then non-finite rows
    (``repro_torch.kernels.pass1_checks``, the card tests' own cases)."""
    import torch
    from repro_torch.kernels import pass1_checks
    for c in PASS1_EDGES:
        for nmod in range(4):
            for key, e in pass1_checks.edge_case(c, nmod, DEVICE).items():
                errs[key] = max(errs.get(key, 0.0), e)
    torch.cuda.synchronize()
    print(f"[kernels] pass 1 at C={list(PASS1_EDGES)}, N=20,000-20,003, "
          "aligned and not: K1 and K6a agree with their plain versions, K4a "
          "bitwise K1, K6a bitwise K1 on the masked decode, repeatable")
    for c in (16, 48):
        for key, e in pass1_checks.nonfinite(c, DEVICE).items():
            errs[key] = max(errs.get(key, 0.0), e)
        torch.cuda.synchronize()
        print(f"[kernels] pass 1 (3, {c}, 20003) non-finite: a dead row of "
              "inf never reaches the median, a live NaN only its own row "
              "(the lone cohort's as the plain version's), K6a bitwise K1, "
              "repeatable")


def _pass1_c48():
    """K1 at the async path's 48 rows (8 masked out) against its plain
    version; its times and bound."""
    from repro_torch.kernels import robust_pipeline as rp
    g, c, n = ASYNC_K1_SHAPE
    x, m, _ = _inputs(ASYNC_K1_SHAPE, c,
                      [[float(i % 6 != 5) for i in range(c)]])
    err = max(_check(f"cosine_gate_partials/{part} {ASYNC_K1_SHAPE}", o, r,
                     rel=NSUM_REL)
              for part, o, r in zip(("dots", "sqnorms", "refsq"),
                                    rp.cosine_gate_partials(x, m),
                                    rp.cosine_gate_partials_plain(x, m)))
    kern = lambda: rp.cosine_gate_partials(x, m)
    b, by = bound(*kernel_work("cosine_gate_partials", g, c, n))
    entry = {"shape": list(ASYNC_K1_SHAPE), "max_abs_err": err,
             "ms": time_ms(kern),
             "plain_ms": time_ms(lambda: rp.cosine_gate_partials_plain(x, m)),
             "bound_ms": b, "bound_by": by, "device_ms": device_ms(kern)}
    print(f"[kernels] cosine_gate_partials {ASYNC_K1_SHAPE}: {entry}; device "
          f"against the earlier design's "
          f"{K1_BEFORE_MS['cosine_gate_partials C=48']} ms")
    return entry


def _plain_pipeline(x, w, m, cfg):
    """The Eq.-11 pipeline through the kernels' plain versions, on the
    tensors' own device."""
    from repro_torch.kernels import robust_pipeline as rp
    return rp.eq11(
        lambda mm: rp.cosine_gate_partials_plain(x, mm),
        lambda mm, ww, mode, tf: rp.gated_combine_plain(x, mm, ww, mode=mode,
                                                        trim_frac=tf),
        lambda mm: rp.pairwise_gram_plain(x), w, m, **rp._pipeline_args(cfg))


def _k5_and_flat(cnn_sizes):
    """Phase 2, continued: K5 against its plain version and bitwise K2; the
    flat wrappers K4a-c bitwise K1-K3; the two-stage scheme at G=2 against
    its plain path; K3 and K6c at C=96.  Returns the K5 and K4a-c entries
    (times at the main path's shape) and K3's and K6c's C=96 times."""
    import torch
    from repro_torch.comm.kernels import comm_codecs as cc
    from repro_torch.configs.base import FedConfig
    from repro_torch.kernels import robust_agg as ra
    from repro_torch.kernels import robust_pipeline as rp

    errs = {}

    def note(key, e):
        errs[key] = max(errs.get(key, 0.0), e)

    for shape in (SLICE_SHAPE, WIDE_SHAPE):
        _, c, n = shape
        x = _inputs((1, c, n), c + n, [[1.0] * c])[0][0]
        masks = {"full": [1.0] * c,
                 "mixed": [float(i % 3 > 0) for i in range(c)],
                 "one": [float(i == 7) for i in range(c)],
                 "empty": [0.0] * c}
        for kind, mk in masks.items():
            m = torch.tensor(mk, device=DEVICE)
            for mode in ra.MODES:
                key, label = f"robust_agg_fwd[{mode}]", f"{shape} {kind}"
                out = ra.robust_agg_fwd(x, m, mode=mode)
                note(key, _check(f"{key} {label}", out,
                                 ra.robust_agg_fwd_plain(x, m, mode=mode),
                                 exact=mode == "median"))
                _bitwise(f"{key} {label}", out,
                         rp.gated_combine(x[None], m[None], m[None],
                                          mode=mode)[0], "K2 in its mode")
                if kind == "empty" and float(out.abs().max()) != 0.0:
                    raise AssertionError(f"{key}: empty mask is not 0")
                if kind == "one":
                    _check(f"{key} {label}", out, x[7], exact=True)
        torch.cuda.synchronize()
        print(f"[kernels] K5 {(c, n)} full/mixed/one/empty masks: both "
              "modes agree with the plain version (median bitwise), bitwise "
              "K2, empty mask exactly 0")

    g, c, n = SLICE_SHAPE
    x, m, w = _inputs(SLICE_SHAPE, 3, [[1.0] * c])
    # the tree's leaves, each its own tensor: they stream through the
    # segment table (rp_*_seg), bitwise the one matrix they come from
    leaves = [l.contiguous() for l in torch.split(x[0], cnn_sizes, dim=1)]
    for agg in ("fedavg", "trimmed_mean", "median", "krum"):
        cfg = FedConfig(n_clients=c, aggregator=agg)
        flat = rp.fused_aggregate_tree_flat(leaves, w[0], m[0], cfg)
        lead = rp.fused_aggregate_tree(leaves, w[0], m[0], cfg)
        whole = torch.split(rp.fused_pipeline(
            x, w, m, **rp._pipeline_args(cfg))[0], cnn_sizes)
        for i, (o, r, d) in enumerate(zip(flat, lead, whole)):
            _bitwise(f"fused_aggregate_tree_flat[{agg}] leaf {i}", o, r,
                     "K1-K3's count")
            _bitwise(f"fused_aggregate_tree[{agg}] leaf {i}", r, d,
                     "the concatenated matrix")
    cfg = FedConfig(n_clients=c, aggregator="trimmed_mean")
    seg_ms = time_ms(lambda: rp.fused_aggregate_tree(leaves, w[0], m[0],
                                                     cfg))
    cat_ms = time_ms(lambda: rp.fused_pipeline(
        torch.cat(leaves, 1)[None], w, m, **rp._pipeline_args(cfg)))
    seg_dev = device_ms(lambda: rp.fused_aggregate_tree(leaves, w[0], m[0],
                                                        cfg))
    cat_dev = device_ms(lambda: rp.fused_pipeline(
        torch.cat(leaves, 1)[None], w, m, **rp._pipeline_args(cfg)))
    print(f"[kernels] tree aggregate, {len(leaves)} leaves {(c, n)} "
          f"trimmed_mean: segment table {seg_ms:.4f} ms (device "
          f"{seg_dev:.4f}), concatenated then one matrix {cat_ms:.4f} ms "
          f"(device {cat_dev:.4f})")
    _bitwise("pairwise_sq_dists_blocked", rp.pairwise_sq_dists_blocked(x, m),
             rp.pairwise_sq_dists(x, m), "K3's distances")
    x2, m2, w2 = _inputs((2, c, n), 4, [[1.0] * c,
                                         [float(i % 3 > 0) for i in range(c)]])
    slots = list(torch.split(x2, cnn_sizes, dim=2))
    for agg in ("fedavg", "trimmed_mean", "median", "krum"):
        cfg = FedConfig(n_clients=c, aggregator=agg)
        out = torch.cat([l.reshape(-1) for l in
                         rp.fused_two_stage_tree(slots, w2, m2, cfg)])
        ref = rp._cross_slot(_plain_pipeline(x2, w2, m2, cfg), m2)
        note("two_stage", _check(f"fused_two_stage_tree[{agg}] G=2", out,
                                 ref, exact=agg == "median"))
    torch.cuda.synchronize()
    print("[kernels] flat wrappers K4a-c bitwise K1-K3 (tree path, four "
          "aggregators); the tree's leaves through the segment table "
          "bitwise their concatenation; two-stage at G=2 agrees with its "
          "plain path")

    gw, cw, nw = GRAM_WIDE_SHAPE
    xg, mg, _ = _inputs(GRAM_WIDE_SHAPE, 96,
                        [[float(i != 5) for i in range(cw)]])
    note("pairwise_gram_c96", _check(f"pairwise_gram {GRAM_WIDE_SHAPE}",
                                     rp.pairwise_gram(xg),
                                     rp.pairwise_gram_plain(xg),
                                     rel=NSUM_REL))
    q, sq, layout = _encode(xg, WIDE_LEAVES)
    k6c = cc.dequant_pairwise_gram(q, sq, layout, mg)
    _check(f"dequant_pairwise_gram {GRAM_WIDE_SHAPE}", k6c,
           cc.dequant_pairwise_gram_plain(q, sq, layout, mg), rel=NSUM_REL)
    _bitwise(f"dequant_pairwise_gram {GRAM_WIDE_SHAPE}", k6c,
             rp.pairwise_gram(cc.dequant_masked(q, sq, layout, mg)))
    c96 = {}
    for name, kern, plain, lib, work in (
            ("pairwise_gram", lambda: rp.pairwise_gram(xg),
             lambda: rp.pairwise_gram_plain(xg),
             lambda: torch.bmm(xg, xg.transpose(1, 2)), {}),
            ("dequant_pairwise_gram",
             lambda: cc.dequant_pairwise_gram(q, sq, layout, mg),
             lambda: cc.dequant_pairwise_gram_plain(q, sq, layout, mg), None,
             dict(nq=layout.n_scales, n_leaves=len(WIDE_LEAVES)))):
        b, by = bound(*kernel_work(name, gw, cw, nw, **work))
        c96[name] = {"shape": list(GRAM_WIDE_SHAPE), "ms": time_ms(kern),
                     "plain_ms": time_ms(plain),
                     "library_ms": time_ms(lib) if lib else None,
                     "bound_ms": b, "bound_by": by,
                     "device_ms": device_ms(kern),
                     "library_device_ms": device_ms(lib) if lib else None}
        print(f"[kernels] {name} {GRAM_WIDE_SHAPE}: {c96[name]}; "
              f"{c96[name]['ms']:.4f} ms against the earlier design's "
              f"{GRAM_BEFORE_MS[name]} ms "
              f"({GRAM_BEFORE_MS[name] / c96[name]['ms']:.1f}x)")

    calls = {
        "robust_agg_fwd[trimmed]": (
            lambda: ra.robust_agg_fwd(x[0], m[0], mode="trimmed"),
            lambda: ra.robust_agg_fwd_plain(x[0], m[0], mode="trimmed"),
            None),
        "robust_agg_fwd[median]": (
            lambda: ra.robust_agg_fwd(x[0], m[0], mode="median"),
            lambda: ra.robust_agg_fwd_plain(x[0], m[0], mode="median"),
            lambda: torch.quantile(x[0], 0.5, dim=0)),
        "cosine_gate_partials_flat": (
            lambda: rp.cosine_gate_partials_flat(x, m),
            lambda: rp.cosine_gate_partials_plain(x, m), None),
        "gated_combine_flat[mean]": (
            lambda: rp.gated_combine_flat(x, m, w, mode="mean"),
            lambda: rp.gated_combine_plain(x, m, w, mode="mean"),
            lambda: torch.matmul(w[:, None, :], x)),
        "gated_combine_flat[trimmed]": (
            lambda: rp.gated_combine_flat(x, m, m, mode="trimmed"),
            lambda: rp.gated_combine_plain(x, m, m, mode="trimmed"), None),
        "gated_combine_flat[median]": (
            lambda: rp.gated_combine_flat(x, m, m, mode="median"),
            lambda: rp.gated_combine_plain(x, m, m, mode="median"),
            lambda: torch.quantile(x, 0.5, dim=1)),
        "pairwise_sq_dists_blocked": (
            lambda: rp.pairwise_sq_dists_blocked(x, m),
            lambda: rp.sq_dists_from_gram(rp.pairwise_gram_plain(x), m),
            lambda: torch.bmm(x, x.transpose(1, 2))),
    }
    report = []
    for name, (kern, plain, lib) in calls.items():
        base = name.partition("[")[0]
        out, ref = kern(), plain()
        pairs = zip(out, ref) if isinstance(out, tuple) else [(out, ref)]
        sums = base in ("cosine_gate_partials_flat",
                        "pairwise_sq_dists_blocked")
        for o, r in pairs:
            note(name, _check(f"{name} {SLICE_SHAPE}", o, r,
                              exact=name.endswith("[median]"),
                              rel=NSUM_REL if sums else None))
        report.append(_timed_entry(
            name, CUDA_SOURCE_K5 if base == "robust_agg_fwd" else CUDA_SOURCE,
            SLICE_SHAPE, errs[name], kern, plain, lib))
    return report, c96


def _gumbel_keys(m, seed):
    import torch
    from repro_torch.kernels import population_select as ps
    gen = torch.Generator(DEVICE).manual_seed(seed)
    pri = torch.rand(m, generator=gen, device=DEVICE) + 0.01
    return torch.log(pri) + ps.draw_gumbel(m, gen)


def _topd_checks():
    """Phase 2b: K7 against its plain versions, bitwise, over
    ``topd_checks.CASES`` (the card tests' own cases), the routes' order,
    and K7's times; returns the report entry (times at the async path's
    shape)."""
    import torch
    from repro_torch.kernels import population_select as ps
    from repro_torch.kernels import topd_checks as tc

    err = 0.0
    for label, m, d, blk, kind in tc.CASES:
        g = tc.keys(m, d, blk, kind, m + d, DEVICE)
        err = max(err, tc.candidates(g, d, blk))
        tc.fused(g, d, blk)
        if kind in tc.ARGSORT_KINDS:
            tc.every_route(g, d, blk)
        print(f"[topd] {label}, M={m} d={d} blk={blk}: K7's candidates "
              "bitwise the plain version's, the fused launch's indices "
              "bitwise the CPU path's"
              + ("; every route gives argsort's order"
                 if kind in tc.ARGSORT_KINDS else ""))
    before = ps.launch_counts()["block_topd"]
    g = _gumbel_keys(40, 1)
    out = ps.topd(g, 64, method="pallas")
    if ps.launch_counts()["block_topd"] != before \
            or not torch.equal(out, ps.topd_argsort(g, 64)):
        raise AssertionError("topd d >= M: not the argsort route")
    dup = torch.tensor([1, 3, 3, 0, 3, 2, 3, 1] * 3, dtype=torch.float32,
                       device=DEVICE)
    if ps.topd(dup, 5, method="pallas", blk=64).tolist() != [1, 2, 4, 6, 9]:
        raise AssertionError("topd: ties do not go to the lowest index")
    torch.cuda.synchronize()
    print("[topd] M=40 d=64 takes the argsort route without K7; ties go to "
          "the lowest index")
    for label, m, d, kind in tc.LARGE_CASES:
        tc.global_path(tc.keys(m, d, d, kind, m + d, DEVICE), d)
        print(f"[topd] {label}, M={m}: past the shared-memory budget, K7's "
              "global path gives bitwise the CPU path's indices")
    for m, d in ((100_000, 16_384),) + TOPD_TIMED:
        tc.smem_path(tc.keys(m, d, 4096, "gumbel", m, DEVICE), d)
    print("[topd] d = 16,384 and the shapes of TOPD_TIMED keep the "
          "one-launch shared-memory path")
    row = _topd_times()[TOPD_TIMED[0]]
    return {"name": "block_topd", "route": "cuda", "source": CUDA_SOURCE_K7,
            "replaces": K7_REPLACES, "launches": None, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "device_ms": row["device_ms"],
            "library_device_ms": row["library_device_ms"],
            "shape": {"M": TOPD_TIMED[0][0], "d": TOPD_TIMED[0][1]},
            "global_path": _topd_large_times()}


def _topd_large_times():
    """K7's global path at TOPD_LARGE_TIMED: device-only and event times
    beside the bound, ``torch.topk`` and the plain version."""
    import torch
    from repro_torch.kernels import population_select as ps
    out = []
    for m, d in TOPD_LARGE_TIMED:
        g = _gumbel_keys(m, 5)
        bound_ms, bound_by = bound(*topd_work(m, d))
        fn = lambda: ps.topd_pallas(g, d)
        lib = lambda: torch.topk(g, d)
        row = {"M": m, "d": d, "ms": time_ms(fn), "device_ms": device_ms(fn),
               "plain_ms": time_ms(lambda: ps.topd_pallas_plain(g, d, d)),
               "library_ms": time_ms(lib), "library_device_ms": device_ms(lib),
               "bound_ms": bound_ms, "bound_by": bound_by}
        out.append(row)
        print(f"[topd] M={m} d={d} (global path): top-d "
              f"{row['device_ms']:.4f} ms device only ({row['ms']:.4f} by "
              f"events), torch.topk {row['library_device_ms']:.4f} "
              f"({row['library_ms']:.4f}), plain {row['plain_ms']:.4f}, "
              f"bound {bound_ms * 1e3:.4f} us ({bound_by})")
    return out


def _topd_times():
    """K7's times at TOPD_TIMED, by CUDA events and device only: the top-d
    as the main path runs it (``topd_pallas``), stage 1 alone
    (``block_topd`` on padded keys), ``torch.topk`` and the plain version
    (``topd_pallas_plain``), beside the bound and K7_BEFORE_MS."""
    import torch
    from repro_torch.kernels import population_select as ps
    timed = {}
    for m, d in TOPD_TIMED:
        g = _gumbel_keys(m, 3)
        gp, _ = ps._pad_neg_inf(g, 4096)
        bound_ms, bound_by = bound(*topd_work(m, d))
        calls = {"": lambda: ps.topd_pallas(g, d),
                 "stage1_": lambda: ps.block_topd(gp, d, 4096),
                 "library_": lambda: torch.topk(g, d)}
        row = {"bound_ms": bound_ms, "bound_by": bound_by}
        for key, fn in calls.items():
            row[f"{key}ms"] = time_ms(fn)
            row[f"{key}device_ms"] = device_ms(fn)
        row["plain_ms"] = time_ms(lambda: ps.topd_pallas_plain(g, d, 4096))
        timed[(m, d)] = row
        was = K7_BEFORE_MS[(m, d)]
        print(f"[topd] M={m} d={d}: top-d {row['device_ms']:.4f} ms device "
              f"only ({row['ms']:.4f} by events; earlier design's K7 + merge "
              f"{was[1]}), stage 1 {row['stage1_device_ms']:.4f} "
              f"({row['stage1_ms']:.4f}; earlier K7 {was[0]}), torch.topk "
              f"{row['library_device_ms']:.4f} ({row['library_ms']:.4f}), "
              f"plain {row['plain_ms']:.4f}, bound {bound_ms * 1e3:.4f} us "
              f"({bound_by})")
    return timed


def _fed_cfg(aggregator, **kw):
    from repro_torch.configs.base import FedConfig
    return FedConfig(n_clients=16, algorithm="fedfits", local_epochs=2,
                     local_lr=0.05, msl=4, pft=2, aggregator=aggregator, **kw)


def _drive(label, model, fed, evaluate, schedule, make_cfg, cap):
    """Runs ``schedule`` [(aggregator, rounds)] through ``fedfits.run`` from
    seed 0; the first run keeps round 1's init, batch and params in
    ``cap``.  Returns {aggregator: (state, history)}."""
    import torch
    from repro_torch import tree
    from repro_torch.core import fedfits

    clone = lambda p: tree.map(lambda t: t.detach().clone(), p)

    def init(gen):
        cap["init"] = clone(model.init(gen))
        return clone(cap["init"])

    def data_fn(t, gen):
        batch = fed.data_fn(t, gen)
        cap.setdefault("batch", batch)
        return batch

    def eval_first(params):
        if "params1" not in cap:        # round 1 (the eager warm-up step)
            cap["params1"] = clone(params)
        return evaluate(params)

    runs = {}
    for i, (agg, rounds) in enumerate(schedule):
        if i == 0:
            state, hist = fedfits.run(
                dataclasses.replace(model, init=init), make_cfg(agg), data_fn,
                rounds, 0, eval_fn=eval_first)
        else:
            state, hist = fedfits.run(model, make_cfg(agg), fed.data_fn,
                                      rounds, 0, eval_fn=evaluate)
        for h in hist:
            team = "".join("#" if v else "." for v in h["team"])
            print(f"[{label}] {agg:<12} {h['round']:>2} team[{team}] "
                  f"alpha={float(h['alpha']):.3f} "
                  f"test_acc={float(h['test_acc']):.4f} "
                  f"wall_ms={h['wall_ms']:.2f}")
        if not all(bool(torch.isfinite(l).all())
                   for l in tree.leaves(state.params)):
            raise AssertionError(f"{label} {agg}: non-finite params")
        runs[agg] = (state, hist)
    torch.cuda.synchronize()
    return runs


def _round1_on_cpu(label, model, cfg, cap, first_row, atol):
    """Round 1 again through the CPU port from the same params and batch:
    the same team, params within ``atol``."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.core import fedfits
    cpu = lambda p: tree.map(lambda t: t.cpu(), p)
    state = fedfits.init_state(cpu(cap["init"]), 16, cfg,
                               torch.Generator().manual_seed(1))
    state, met = fedfits.make_round(model, cfg)(state, cpu(cap["batch"]))
    if not np.array_equal(met["team"].numpy(), first_row["team"]):
        raise AssertionError(f"{label} round 1: CPU and card teams differ")
    diff = max(float((a - b.cpu()).abs().max()) for a, b in zip(
        tree.leaves(state.params), tree.leaves(cap["params1"])))
    print(f"[{label}] round 1 on the CPU port: same team, params max abs diff "
          f"{diff:.3e} (atol {atol:.3e})")
    if diff > atol:
        raise AssertionError(f"{label} round 1: CPU and card params differ")


def _launched(label, counts):
    print(f"[{label}] launches {json.dumps(counts)}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {label} path: "
                             f"{missing}")


def _round(model, fed, evaluate):
    """Phase 3: the port's main path; returns the launch counts and the
    fedavg history."""
    from repro_torch.kernels import robust_pipeline as rp

    cap = {}
    rp.reset_launch_counts()
    runs = _drive("round", model, fed, evaluate,
                  [("fedavg", 10), ("trimmed_mean", 2), ("median", 2),
                   ("krum", 2)], _fed_cfg, cap)
    counts = rp.launch_counts()
    _launched("round", counts)
    first = runs["fedavg"][1]
    acc0, acc_end = float(first[0]["test_acc"]), float(first[-1]["test_acc"])
    if not acc_end > acc0:
        raise AssertionError(f"fedavg test_acc did not improve: {acc0} -> "
                             f"{acc_end}")
    _round1_on_cpu("round", model, _fed_cfg("fedavg"), cap, first[0],
                   ROUND1_ATOL)
    return counts, first


def _billed(hist, k):
    """Client-rounds a history bills: every client in a round that
    reselects (h), the team otherwise."""
    total, h = 0.0, True
    for row in hist:
        total += k if h else float(row["team"].sum())
        h = bool(row["h_next"])
    return total


def _int8_step(model, cfg, cap):
    """One quantisation step of round 1: its largest int8 scale, the
    largest |w_k - w| over 127 (the EF residual is still 0)."""
    from repro_torch import tree
    from repro_torch.core import fedfits
    cpu = lambda p: tree.map(lambda t: t.cpu(), p)
    params = cpu(cap["init"])
    local, _ = fedfits.make_client_update(model, cfg)(params,
                                                      cpu(cap["batch"]))
    return max(float((a - b).abs().max()) for a, b in zip(
        tree.leaves(local), tree.leaves(params))) / 127.0


def _compressed_round(model, fed, evaluate, dense_fedavg):
    """Phase 4: the compressed uplink on the card; returns K6's launch
    counts."""
    from repro_torch.comm.kernels import comm_codecs as cc
    from repro_torch.kernels import robust_pipeline as rp

    make_cfg = lambda agg, comp="int8": _fed_cfg(agg, compress=comp,
                                                 error_feedback=True)
    cap = {}
    rp.reset_launch_counts()
    cc.reset_launch_counts()
    runs = _drive("int8", model, fed, evaluate,
                  [("fedavg", 4), ("trimmed_mean", 2), ("median", 2),
                   ("krum", 2)], make_cfg, cap)
    counts = cc.launch_counts()
    _launched("int8", counts)
    state, hist = runs["fedavg"]
    acc0, acc4 = float(hist[0]["test_acc"]), float(hist[3]["test_acc"])
    if not acc4 > acc0:
        raise AssertionError(f"int8 fedavg test_acc did not improve: {acc0} "
                             f"-> {acc4}")
    rounds = float(state.cost_client_rounds)
    per = float(state.cost_bytes_up) / rounds
    dense = _billed(dense_fedavg[:4], 16)
    print(f"[int8] fedavg 4 rounds: {rounds:.0f} client-rounds (dense path "
          f"{dense:.0f}), {per:.1f} B up per client-round")
    if per != INT8_BYTES_PER_CLIENT:
        raise AssertionError(f"int8 bills {per} B per client-round, not "
                             f"{INT8_BYTES_PER_CLIENT}")
    if rounds != dense:
        raise AssertionError(f"int8 bills {rounds} client-rounds, the dense "
                             f"path {dense}")
    step = _int8_step(model, make_cfg("fedavg"), cap)
    _round1_on_cpu("int8", model, make_cfg("fedavg"), cap, hist[0],
                   step + ROUND1_ATOL)

    rp.reset_launch_counts()
    for comp in ("int4", "signsgd", "topk", "randk"):
        runs = _drive(comp, model, fed, evaluate, [("trimmed_mean", 1)],
                      lambda agg: make_cfg(agg, comp), {})
        state, _ = runs["trimmed_mean"]
        per = float(state.cost_bytes_up) / float(state.cost_client_rounds)
        print(f"[{comp}] {per:.1f} B up per client-round")
    _launched("other codecs", {k: v for k, v in rp.launch_counts().items()
                               if k in ("cosine_gate_partials",
                                        "gated_combine[trimmed]")})
    return counts


def _async_cfg(aggregator):
    from repro_torch.configs.base import FedConfig
    return FedConfig(n_clients=ASYNC_C, population=ASYNC_M, local_epochs=2,
                     local_lr=0.05, aggregator=aggregator,
                     async_max_retries=2, async_deadline=1.0,
                     async_backoff=1.5, staleness_decay=0.5,
                     select_method="pallas")


def _async_round1_on_cpu(model, pop, faults):
    """Round 1 of the async path again: on the card from run_async's seed,
    traced by torch.profiler, then on the CPU port with the card's draws;
    the same cohort, on-time mask and buffer, params within 1e-5."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tree
    from repro_torch.core import async_engine as ae
    from repro_torch.launch.profile_round import busy_ms
    cfg = _async_cfg("trimmed_mean")
    cpu = lambda t: tree.map(lambda v: v.cpu(), t)
    gen = lambda s: torch.Generator(DEVICE).manual_seed(s)
    state = ae.init_async_state(model.init(gen(0)), cfg, gen(1))
    init = cpu(state.params)
    draw, round_fn = ae.make_async_round(model, cfg, pop, faults=faults)
    draws = draw(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gpu, m_gpu = round_fn(state, draws)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation]
    busy = busy_ms(dev_events)
    print(f"[async] round 1 traced: {len(dev_events)} device events, "
          f"device busy {busy:.3f} ms")
    _, round_cpu = ae.make_async_round(model, cfg, cpu(pop), faults=faults)
    host, m_cpu = round_cpu(ae.init_async_state(init, cfg, torch.Generator()),
                            cpu(draws))
    for k in ("cohort", "on_time", "due", "exhausted"):
        if not torch.equal(m_gpu[k].cpu(), m_cpu[k]):
            raise AssertionError(f"async round 1: CPU and card {k} differ")
    for k in ("owner", "age", "active", "n_k"):
        if not torch.equal(getattr(gpu.buf, k).cpu(), getattr(host.buf, k)):
            raise AssertionError(f"async round 1: CPU and card buf.{k} "
                                 "differ")
    rem = float((gpu.buf.remaining.cpu() - host.buf.remaining).abs().max())
    diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree.leaves(gpu.params), tree.leaves(host.params)))
    parked = float((gpu.buf.upd.cpu() - host.buf.upd).abs().max())
    print(f"[async] round 1 on the CPU port: same cohort, on-time mask and "
          f"buffer; params max abs diff {diff:.3e}, parked rows "
          f"{parked:.3e}, remaining {rem:.3e} (atol {ROUND1_ATOL:.0e})")
    if max(diff, parked) > ROUND1_ATOL or rem > 1e-6:
        raise AssertionError("async round 1: CPU and card differ")
    return m_gpu


def _async_phase(model):
    """Phase 5: the buffered-async engine at full width; returns K7's and
    K1-K3's launch counts over the run, and (the federation, its server
    test set, the stragglers' FaultConfig) for phase 5b."""
    import torch
    from repro_torch import tree
    from repro_torch.core import async_engine as ae
    from repro_torch.core.faults import FaultConfig
    from repro_torch.data.pipeline import build_federation
    from repro_torch.kernels import population_select as ps
    from repro_torch.kernels import robust_pipeline as rp

    t0 = time.perf_counter()
    fed, test = build_federation(0, kind="images", n=ASYNC_N,
                                 n_clients=ASYNC_M, dirichlet_alpha=1.0,
                                 batch_size=32)
    pop = fed.data
    mb = sum(v.numel() * v.element_size() for v in pop.values()) / 1e6
    print(f"[async] federation: M={ASYNC_M}, n={ASYNC_N}, cap {fed.cap}, "
          f"{mb:.0f} MB on the card, built in "
          f"{time.perf_counter() - t0:.1f} s")
    late = FaultConfig(straggler_frac=0.3, straggler_delay=3.0,
                       base_delay=0.3)

    def evaluate(params):
        _, met = model.loss(params, test)
        return {"test_acc": met["acc"]}

    rp.reset_launch_counts()
    ps.reset_launch_counts()
    runs, rounds = {}, 0
    for agg, n_rounds in ASYNC_SCHEDULE:
        state, hist = ae.run_async(model, _async_cfg(agg), pop, n_rounds, 0,
                                   eval_fn=evaluate, faults=late)
        rounds += n_rounds
        for h in hist:
            print(f"[async] {agg:<12} {h['round']:>2} cohort "
                  f"{h['cohort'][:4].tolist()}.. on_time "
                  f"{int(h['on_time'].sum())}/{ASYNC_C} landed "
                  f"{int(h['due'].sum())} buffered {int(h['buffered'])} "
                  f"abandoned {int(h['abandoned'])} buf_fill "
                  f"{int(h['buf_fill'])} test_acc "
                  f"{float(h['test_acc']):.4f} wall_ms {h['wall_ms']:.2f}")
        if not all(bool(torch.isfinite(l).all())
                   for l in tree.leaves(state.params)):
            raise AssertionError(f"async {agg}: non-finite params")
        cr, up = float(state.cost_client_rounds), float(state.cost_bytes_up)
        if cr != ASYNC_C * n_rounds \
                or up != ASYNC_C * n_rounds * DENSE_BYTES_PER_CLIENT:
            raise AssertionError(f"async {agg}: billed {cr} client-rounds and "
                                 f"{up} B up over {n_rounds} rounds")
        runs[agg] = hist
    torch.cuda.synchronize()
    counts = {**ps.launch_counts(), **rp.launch_counts()}
    _launched("async", counts)
    if counts["block_topd"] != rounds:
        raise AssertionError(f"K7 launched {counts['block_topd']} times in "
                             f"{rounds} rounds")
    every = [h for hist in runs.values() for h in hist]
    parked = sum(float(h["buffered"]) for h in every)
    landed = sum(float(h["due"].sum()) for h in every)
    print(f"[async] {rounds} rounds: {parked:.0f} deliveries parked, "
          f"{landed:.0f} landed from the buffer, "
          f"{sum(float(h['abandoned']) for h in every):.0f} abandoned; "
          f"billing exact ({ASYNC_C} client-rounds and "
          f"{ASYNC_C * DENSE_BYTES_PER_CLIENT} B up a round)")
    if not (parked > 0 and landed > 0):
        raise AssertionError("async: no delivery was parked and landed")
    tm = runs["trimmed_mean"]
    acc0, acc_end = float(tm[0]["test_acc"]), float(tm[-1]["test_acc"])
    if not acc_end > acc0:
        raise AssertionError(f"async trimmed_mean test_acc did not improve: "
                             f"{acc0} -> {acc_end}")
    m1 = _async_round1_on_cpu(model, pop, late)
    if not torch.equal(m1["cohort"].cpu(), torch.from_numpy(tm[0]["cohort"])):
        raise AssertionError("async round 1 rerun: not run_async's cohort")
    return counts, (fed, test, late)


def _run_diff(a, b):
    """(largest |a - b|, the keys whose bits differ) of two (state or
    summary, history) runs: every state tensor and every history value
    (host clocks aside); (0.0, []) when they are bitwise equal."""
    import numpy as np
    import torch
    from repro_torch import tree
    (sa, ha), (sb, hb) = a, b
    worst, keys = 0.0, set()
    for ra, rb in zip(ha, hb):
        for k, v in ra.items():
            if k in ("wall_ms", "chunk_ms"):
                continue
            x, y = np.asarray(v), np.asarray(rb[k])
            if x.dtype != y.dtype or x.tobytes() != y.tobytes():
                keys.add(k)
                worst = max(worst, float(np.max(np.abs(
                    x.astype(np.float64) - y.astype(np.float64)))))
    if isinstance(sa, dict):                    # run_scenario's summaries
        for k, v in sa.items():
            if k != "wall_s" and v != sb[k]:
                keys.add(k)
        return worst, sorted(keys)
    tb = dict(_state_tensors(sb))
    for name, x in _state_tensors(sa):
        y = tb[name]
        if name == "buf.rows":      # the drop row takes the dropped parks in
            x, y = x[:-1], y[:-1]   # no set order and is never read
        if not torch.equal(x, y):
            keys.add(name)
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst, sorted(keys)


def _state_tensors(state, path=""):
    """(dotted path, tensor) of every tensor in a round state."""
    import torch
    if isinstance(state, torch.Tensor):
        yield path.rstrip("."), state
    elif hasattr(state, "_fields"):
        for f in state._fields:
            yield from _state_tensors(getattr(state, f), f"{path}{f}.")
    elif isinstance(state, dict):
        for k in sorted(state):
            yield from _state_tensors(state[k], f"{path}{k}.")
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            yield from _state_tensors(v, f"{path}{i}.")


def _parity_case(label, run, atol=None):
    """One parity case: ``run(driver)`` twice under ``python`` and once
    under ``scan``.  With ``atol`` None the two loops and scan must be
    bitwise equal; else (cuDNN's default algorithms, under which the loop
    itself does not repeat) every mask must be equal and every other value
    within ``atol``.  The kernels' launches must be equal."""
    from repro_torch.kernels import launches
    out, counts = {}, {}
    for name, drv in (("python", "python"), ("python'", "python"),
                      ("scan", "scan")):
        before = launches.snapshot()
        out[name] = run(drv)
        counts[name] = {f"{f.__name__}[{m}]" if m else f.__name__: n
                        for (f, m), n in launches.since(before).items()}
    spread, s_keys = _run_diff(out["python'"], out["python"])
    err, e_keys = _run_diff(out["scan"], out["python"])
    word = lambda e, k: "bitwise" if not k else f"max abs {e:.3e} in {k}"
    print(f"[parity] {label}: scan vs python {word(err, e_keys)}; two "
          f"python runs {word(spread, s_keys)}; launches {counts['scan']}")
    if counts["scan"] != counts["python"]:
        raise AssertionError(f"{label}: scan launched {counts['scan']}, "
                             f"python {counts['python']}")
    if atol is None and (e_keys or s_keys):
        raise AssertionError(f"{label}: not bitwise")
    if atol is not None and (err > atol or set(e_keys) & set(MASK_KEYS)):
        raise AssertionError(f"{label}: scan is not the per-round loop "
                             f"within {atol}")


def _parity(model, fed, evaluate, async_side):
    """Phase 5b: driver="scan" (the round captured as a CUDA graph and
    replayed) against driver="python" on the card: bitwise under cuDNN's
    deterministic algorithms, and within PARITY_DEFAULT_ATOL under its
    defaults, whose convolution backward does not repeat."""
    import torch
    from repro_torch.core import async_engine as ae
    from repro_torch.core import fedfits
    from repro_torch.scenarios import run_scenario
    t0 = time.perf_counter()
    sync = lambda cfg: lambda drv: fedfits.run(
        model, cfg, fed.data_fn, PARITY_ROUNDS, 0, eval_fn=evaluate,
        driver=drv, chunk_rounds=PARITY_CHUNK)
    afed, atest, late = async_side

    def aeval(params):
        _, met = model.loss(params, atest)
        return {"test_acc": met["acc"]}

    sc = _cell(PARITY_CELL)
    torch.backends.cudnn.deterministic = True
    try:
        for agg in PARITY_AGGS:
            _parity_case(f"sync {agg} {PARITY_ROUNDS} rounds", sync(
                _fed_cfg(agg, avail_prob=0.8, explore_eps=0.1)))
        _parity_case(f"sync trimmed_mean int8+EF {PARITY_ROUNDS} rounds",
                     sync(_fed_cfg("trimmed_mean", avail_prob=0.8,
                                   explore_eps=0.1, compress="int8",
                                   error_feedback=True)))
        _parity_case(
            f"async trimmed_mean M={ASYNC_M} {PARITY_ROUNDS} rounds",
            lambda drv: ae.run_async(model, _async_cfg("trimmed_mean"),
                                     afed.data, PARITY_ROUNDS, 0,
                                     eval_fn=aeval, faults=late, driver=drv))
        _parity_case(
            f"scenario {PARITY_CELL} {ROBUST_ROUNDS} rounds",
            lambda drv: run_scenario(sc, n_clients=ROBUST_K,
                                     n_rounds=ROBUST_ROUNDS, kind="images",
                                     arch="paper-cnn", n=4000, driver=drv))
    finally:
        torch.backends.cudnn.deterministic = False
    _parity_case(f"sync fedavg {PARITY_ROUNDS} rounds, cuDNN's default "
                 "algorithms", sync(_fed_cfg("fedavg", avail_prob=0.8,
                                             explore_eps=0.1)),
                 atol=PARITY_DEFAULT_ATOL)
    print(f"[parity] phase 5b took {time.perf_counter() - t0:.1f} s")


def _timing(fed, async_side, smi):
    """Phase 5c: the round wall under both drivers, in this run: the median
    of 10 steady rounds, device busy, idle share and launches from the
    host in one traced round (``repro_torch.launch.profile_round``)."""
    import types
    import torch
    from repro_torch.launch import profile_round as pr
    dev = torch.device(DEVICE)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    out = {}
    for engine, agg, setup, f in (
            ("sync", "fedavg", pr.sync_round, fed),
            ("async", "trimmed_mean", pr.async_round, async_side[0])):
        args = types.SimpleNamespace(aggregator=agg, compress="none")
        for drv in ("python", "scan"):
            m = pr.measure(*setup(args, dev, gen, fed=f), driver=drv,
                           device=dev)
            out[engine, drv] = m
            chunk = (f", {m['chunk_round_ms']:.3f} ms a round over a chunk "
                     f"of {pr.ROUNDS}" if "chunk_round_ms" in m else "")
            print(f"[timing] {engine} {agg} driver={drv}: round wall median "
                  f"{m['median_ms']:.3f} ms (min {min(m['walls']):.3f}, max "
                  f"{max(m['walls']):.3f}){chunk}; traced round wall "
                  f"{m['traced_ms']:.3f} ms, device busy {m['busy_ms']:.3f} "
                  f"ms (kernels summed {m['kernel_ms']:.3f}), idle share "
                  f"{m['idle']:.3f}, {m['host_launches']} launches from the "
                  f"host | {smi}")
    return out


def _obs_check(engine, jsonl, trace):
    """``python -m repro_torch.obs.check`` on a run's artifacts; raises on
    a finding."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.check", "--require-obs",
         "--min-phases", "5", "--engine", engine, "--jsonl", jsonl,
         "--trace", trace], env=env, capture_output=True, text=True,
        timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"{engine} telemetry artifacts: "
                             f"{proc.stdout} {proc.stderr}")
    return proc.stdout.strip()


def _without_obs(run):
    """A (state, history) run with its telemetry column and obs/ keys
    taken out."""
    state, hist = run
    return (state._replace(tele=None),
            [{k: v for k, v in r.items() if not k.startswith("obs/")}
             for r in hist])


def _telemetry(model, fed, evaluate, async_side, smi):
    """Phase 5d: telemetry through the replayed rounds.  Sync fedavg and
    async trimmed_mean at phase 5b's shapes under the default driver:
    telemetry on and off bitwise (params, generators, billing and every
    non-obs value) under cuDNN's deterministic algorithms, the counter
    column's totals the rows' sums, the JSONL and trace passing
    ``repro_torch.obs.check``; then the replayed round's wall median and
    launches from the host with telemetry on and off."""
    import types
    import torch
    from repro_torch.core import async_engine as ae
    from repro_torch.core import fedfits
    from repro_torch.launch import profile_round as pr
    from repro_torch.obs import JsonlSink, Telemetry
    t0 = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    afed, atest, late = async_side

    def aeval(params):
        _, met = model.loss(params, atest)
        return {"test_acc": met["acc"]}

    runs = {
        "sync": lambda tel: fedfits.run(
            model, _fed_cfg("fedavg", avail_prob=0.8, explore_eps=0.1),
            fed.data_fn, PARITY_ROUNDS, 0, eval_fn=evaluate,
            chunk_rounds=PARITY_CHUNK, telemetry=tel),
        "async": lambda tel: ae.run_async(
            model, _async_cfg("trimmed_mean"), afed.data, PARITY_ROUNDS, 0,
            eval_fn=aeval, faults=late, telemetry=tel)}
    torch.backends.cudnn.deterministic = True
    try:
        for engine, run in runs.items():
            jsonl = str(out_dir / f"{engine}.jsonl")
            trace = str(out_dir / f"{engine}_trace.json")
            tel = Telemetry(sinks=[JsonlSink(jsonl)], trace_path=trace,
                            run_name=f"chip_smoke {engine}")
            on = run(tel)
            summary = tel.finish()
            off = run(None)
            err, keys = _run_diff(off, _without_obs(on))
            if keys:
                raise AssertionError(f"telemetry {engine}: on and off differ "
                                     f"in {keys} (max abs {err:.3e})")
            state, hist = on
            for name in ("wire/bytes_up", "gate/cosine_rejected"):
                total = sum(float(r["obs/" + name]) for r in hist)
                if float(state.tele[name]) != total:
                    raise AssertionError(f"telemetry {engine}: the column's "
                                         f"{name} is not the rows' sum")
            print(f"[telemetry] {engine} {PARITY_ROUNDS} rounds, driver "
                  f"scan: on vs off bitwise (deterministic cuDNN); "
                  f"{summary['rows']} rows, {summary['n_warnings']} "
                  f"warnings; last row obs/cohort/trust_q "
                  f"{hist[-1]['obs/cohort/trust_q'].tolist()}; "
                  f"{_obs_check(engine, jsonl, trace)}")
    finally:
        torch.backends.cudnn.deterministic = False
    dev = torch.device(DEVICE)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    for engine, agg, setup, f in (
            ("sync", "fedavg", pr.sync_round, fed),
            ("async", "trimmed_mean", pr.async_round, afed)):
        args = types.SimpleNamespace(aggregator=agg, compress="none")
        for on in (False, True):
            m = pr.measure(*setup(args, dev, gen, fed=f, telemetry=on),
                           driver="scan", device=dev,
                           telemetry=Telemetry() if on else None)
            print(f"[telemetry] {engine} {agg} replayed round, telemetry "
                  f"{'on' if on else 'off'}: wall median "
                  f"{m['median_ms']:.3f} ms (min {min(m['walls']):.3f}, max "
                  f"{max(m['walls']):.3f}), {m['chunk_round_ms']:.3f} ms a "
                  f"round over a chunk of {pr.ROUNDS}; traced round device "
                  f"busy {m['busy_ms']:.3f} ms, {m['host_launches']} "
                  f"launches from the host | {smi}")
    print(f"[telemetry] phase 5d took {time.perf_counter() - t0:.1f} s")


def _counts():
    """Every launch counter of the port's kernels, by name."""
    from repro_torch.comm.kernels import comm_codecs as cc
    from repro_torch.kernels import robust_agg as ra
    from repro_torch.kernels import robust_pipeline as rp
    return {**rp.launch_counts(), **rp.flat_launch_counts(),
            **cc.launch_counts(), **ra.launch_counts()}


def _poisoning_defense():
    """Phase 6a: the port's examples/poisoning_defense.py on the card."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.paper_models import MLP_CONFIG
    from repro_torch.core import aggregation, attacks, fedfits
    from repro_torch.data.pipeline import build_federation
    from repro_torch.kernels import robust_agg as ra
    from repro_torch.kernels import robust_agg_ops
    from repro_torch.kernels import robust_pipeline as rp
    from repro_torch.models.model import build

    k, rounds, n_mal = 10, 12, 2
    model = build(MLP_CONFIG)
    fed, test = build_federation(0, kind="tabular", n=1600, n_clients=k,
                                 batch_size=32, n_classes=22)
    mal = (torch.arange(k, device=DEVICE) < n_mal).float()

    def sign_flip(upd, m, noise):
        return attacks.sign_flip(upd, m, scale=10.0)

    def evaluate(params):
        _, met = model.loss(params, test)
        return {"test_acc": met["acc"]}

    billed = {}
    for agg, comp in (("fedavg", "none"), ("median", "none"),
                      ("trimmed_mean", "none"), ("krum", "none"),
                      ("trimmed_mean", "int8")):
        cfg = FedConfig(n_clients=k, algorithm="fedfits", aggregator=agg,
                        local_epochs=2, local_lr=0.05,
                        cosine_outlier_thresh=-0.5, compress=comp)
        state, hist = fedfits.run(model, cfg, fed.data_fn, rounds, 2,
                                  eval_fn=evaluate, update_attack=sign_flip,
                                  malicious=mal)
        accs = [float(h["test_acc"]) for h in hist]
        if not all(bool(torch.isfinite(l).all())
                   for l in tree.leaves(state.params)):
            raise AssertionError(f"poisoning {agg} {comp}: non-finite params")
        billed[(agg, comp)] = float(state.cost_client_rounds)
        print(f"[robust] poisoning aggregator={agg:<12} compress={comp:<4} "
              f"best_acc={max(accs):.3f} final={accs[-1]:.3f} gated "
              f"{sum(float(h['gated_frac']) for h in hist) / rounds:.3f} "
              f"uplink {float(state.cost_bytes_up) / 1e6:.2f} MB "
              f"client-rounds {billed[(agg, comp)]:.0f}")
    if billed[("trimmed_mean", "int8")] != billed[("trimmed_mean", "none")]:
        raise AssertionError("poisoning: int8 does not bill the dense run's "
                             "client-rounds")

    gen = torch.Generator(DEVICE).manual_seed(3)
    honest = torch.randn(k, 512, generator=gen, device=DEVICE) * 0.01 + 1.0
    poisoned = attacks.sign_flip(honest, mal, scale=10.0)
    naive = float(poisoned.mean())
    ones = torch.ones(k, device=DEVICE)
    label = f"poisoned {tuple(poisoned.shape)}"
    for mode in ("trimmed", "median"):
        out = robust_agg_ops.robust_aggregate_tree(
            {"w": poisoned}, ones, mode=mode)["w"]
        _check(f"K5 robust_agg_fwd[{mode}] {label}", out,
               ra.robust_agg_fwd_plain(poisoned, ones, mode=mode),
               exact=mode == "median")
        mean = float(out.mean())
        print(f"[robust] K5 robust_agg[{mode}] mean coordinate {mean:.4f} "
              f"(honest 1.0; naive mean {naive:.4f}); agrees with its plain "
              "version")
        if abs(mean - 1.0) > 0.01:
            raise AssertionError(f"K5 {mode} did not hold off the poison")
    slots, sw = poisoned.view(2, k // 2, 512), ones.view(2, -1)
    for agg in ("fedavg", "trimmed_mean", "median", "krum"):
        cfg = FedConfig(n_clients=k, aggregator=agg, krum_f=n_mal)
        exact = agg == "median"
        flat = rp.fused_aggregate_tree_flat({"w": poisoned}, ones, ones,
                                            cfg)["w"]
        _check(f"flat path K4a-c [{agg}] {label}", flat, _plain_pipeline(
            poisoned[None], ones[None], ones[None], cfg)[0], exact=exact)
        two = aggregation.two_stage({"w": slots}, sw, sw, cfg)["w"]
        _check(f"two-stage [{agg}] {label}", two, rp._cross_slot(
            _plain_pipeline(slots, sw, sw, cfg), sw), exact=exact)
        _bitwise(f"fused_two_stage_tree_flat [{agg}] {label}",
                 rp.fused_two_stage_tree_flat({"w": slots}, sw, sw,
                                              cfg)["w"], two, "two_stage")
        flat, two = float(flat.mean()), float(two.mean())
        print(f"[robust] flat path K4a-c [{agg}] mean coordinate {flat:.4f}; "
              f"two-stage (2 cohorts of 5) {two:.4f}; both agree with their "
              "plain paths")
        for what, v in (("flat path", flat), ("two-stage", two)):
            if abs(v - 1.0) > 0.01:
                raise AssertionError(f"{what} {agg} did not hold off the "
                                     "poison")


def _cell(name):
    """A registry cell, with a ``+partial0.1``, ``+gate0``, ``+retries4``
    or ``+gaussian`` (a noisy update attack, sigma 0.05) variant."""
    import dataclasses
    from repro_torch.scenarios import registry
    base, _, variant = name.partition("+")
    sc = registry.get(base)
    if variant == "partial0.1":
        sc = sc.replace(faults=dataclasses.replace(sc.faults,
                                                   partial_min_frac=0.1))
    elif variant == "gate0":
        sc = sc.replace(fed=(("cosine_outlier_thresh", 0.0),))
    elif variant == "retries4":
        sc = sc.replace(fed=(("async_max_retries", 4),))
    elif variant == "gaussian":
        sc = sc.replace(attack="gaussian", attack_scale=0.05)
    return sc


def _billed_sync(hist):
    """Client-rounds a sync history must bill: every available client in a
    round that reselects, else every team member, dropped ones too."""
    total, h = 0.0, True
    for row in hist:
        total += float(row["avail"].sum()) if h else float(row["team"].sum())
        h = bool(row["h_next"])
    return total


def _robust_cells():
    """Phase 6b: named registry cells at paper-cnn width through
    ``run_scenario``; returns each cell's first history row."""
    from repro_torch.scenarios import run_scenario

    print(f"[robust] {'cell':34s} {'best':>6s} {'final':>6s} {'trig':>6s} "
          f"{'worst10%':>8s} {'acc_var':>8s} {'gini':>5s} {'gated':>6s}")
    first = {}
    for name in ROBUST_CELLS:
        sc = _cell(name)
        before = _counts()
        summ, hist = run_scenario(sc, n_clients=ROBUST_K,
                                  n_rounds=ROBUST_ROUNDS, kind="images",
                                  arch="paper-cnn", n=4000)
        launched = {k: v - before[k] for k, v in _counts().items()}
        first[name] = hist[0]
        print(f"[robust] {name:34s} {summ['best_acc']:6.3f} "
              f"{summ['final_acc']:6.3f} {summ['final_trigger_acc']:6.3f} "
              f"{summ['fair_worst_decile']:8.3f} {summ['fair_acc_var']:8.4f} "
              f"{summ['fair_part_gini']:5.2f} {summ['gated_frac_mean']:6.2f}"
              f"  wall {summ['wall_s']:.2f} s")
        mode = {"trimmed_mean": "trimmed", "median": "median"}.get(
            sc.aggregator, "mean")
        need = [f"gated_combine[{mode}]", "cosine_gate_partials"]
        if sc.compress == "int8":
            need = [f"dequant_gated_combine[{mode}]", "dequant_gate_partials"]
        if sc.aggregator == "krum":
            need.append("pairwise_gram")
        if any(launched[k] == 0 for k in need):
            raise AssertionError(f"{name}: {need} did not all launch "
                                 f"({launched})")
        if sc.async_mode:
            want = float(ROBUST_K * ROBUST_ROUNDS)
        else:
            want = _billed_sync(hist)
        if summ["cost_client_rounds"] != want:
            raise AssertionError(f"{name}: billed {summ['cost_client_rounds']}"
                                 f" client-rounds, not {want}")
        if sc.faults.dropout_active and not any(
                float(h["fault_lost"]) > 0 for h in hist):
            raise AssertionError(f"{name}: no update was lost")
        if name.endswith("partial0.1") and not any(
                float(h["fault_eff_epochs"]) < 2 for h in hist):
            raise AssertionError(f"{name}: no client stopped early")
        if sc.attack == "cross_round" and len(
                {float(h["attack_blend"]) for h in hist}) < 2:
            raise AssertionError(f"{name}: the attacker's blend never moved")
        if name == "signflip_fedfits+gate0" and not (
                summ["gate_trust_malicious"] < summ["gate_trust_honest"]):
            raise AssertionError(f"{name}: malicious gate_trust "
                                 f"{summ['gate_trust_malicious']} not below "
                                 f"honest {summ['gate_trust_honest']}")
    return first


def _attacked_int8_step(s, state, batch, draws):
    """One quantisation step of round 1 (CPU): the largest block scale an
    int8 code can have, max |attacked update| / 127 (the EF residual is
    still 0)."""
    import torch
    from repro_torch import tree
    from repro_torch.core import faults, fedfits
    cfg = s.fed_cfg
    eff = faults.sample_epochs(draws["epoch_frac"], cfg.local_epochs) \
        if "epoch_frac" in draws else None
    local, _ = fedfits.make_client_update(s.model, cfg)(state.params, batch,
                                                        eff)
    flat = torch.cat([(a - b).reshape(ROBUST_K, -1) for a, b in
                      zip(tree.leaves(local), tree.leaves(state.params))], 1)
    flat = s.update_attack(flat, s.malicious, draws.get("update_noise"))
    return float(flat.abs().max()) / 127.0


def _replay_round1(name, row1):
    """Round 1 of a phase-6b cell again, on the card from ``run_scenario``'s
    seeds and on the CPU port with the card's draws: the same team or
    cohort, gated, lost and epoch masks (the buffer, async), params within
    1e-5 (int8: one quantisation step)."""
    import torch
    from repro_torch import tree
    from repro_torch.core import async_engine as ae
    from repro_torch.core import fedfits
    from repro_torch.data.pipeline import build_federation
    from repro_torch.scenarios import engine

    sc = _cell(name)
    cpu = lambda t: tree.map(lambda v: v.cpu(), t)
    gen = lambda seed: torch.Generator(DEVICE).manual_seed(seed)
    sides = {d: engine.setup(sc, n_clients=ROBUST_K, kind="images",
                             arch="paper-cnn", device=d)
             for d in (DEVICE, "cpu")}
    s = sides[DEVICE]
    fed, _ = build_federation(0, kind="images", n=4000,
                              n_clients=s.population, batch_size=32, sep=1.0,
                              dirichlet_alpha=1.0)
    att = {d: v.update_attack if getattr(v.update_attack, "stateful", False)
           else None for d, v in sides.items()}
    kw = lambda v: dict(data_attack=v.data_attack,
                        update_attack=v.update_attack, malicious=v.malicious,
                        faults=sc.faults)
    params = s.model.init(gen(1))              # run_scenario's seed + 1
    init = cpu(params)
    if sc.async_mode:
        state = ae.init_async_state(params, s.fed_cfg, gen(2),
                                    attacker=att[DEVICE])
        draw, round_fn = ae.make_async_round(
            s.model, s.fed_cfg, fed.data, batch_size=fed.batch_size,
            eval_batch=fed.eval_batch, straggler_rows=sc.straggler_rows,
            **kw(s))
        draws = draw(state)
        gpu, mg = round_fn(state, draws)
        _, round_cpu = ae.make_async_round(
            s.model, s.fed_cfg, cpu(fed.data), batch_size=fed.batch_size,
            eval_batch=fed.eval_batch, straggler_rows=sc.straggler_rows,
            **kw(sides["cpu"]))
        host, mc = round_cpu(ae.init_async_state(
            init, s.fed_cfg, torch.Generator(), attacker=att["cpu"]),
            cpu(draws))
        exact = ("cohort", "on_time", "due", "exhausted")
        step = 0.0
        if not torch.equal(mg["cohort"].cpu(), torch.from_numpy(
                row1["cohort"])):
            raise AssertionError(f"{name} round 1 rerun: not run_scenario's "
                                 "cohort")
        for k in ("owner", "age", "active"):
            if not torch.equal(getattr(gpu.buf, k).cpu(),
                               getattr(host.buf, k)):
                raise AssertionError(f"{name} round 1: buf.{k} differs")
    else:
        state = fedfits.init_state(params, ROBUST_K, s.fed_cfg, gen(2),
                                   attacker=att[DEVICE])
        batch = fed.data_fn(1, gen(3))
        round_fn = fedfits.make_round(s.model, s.fed_cfg, **kw(s))
        draws = round_fn.draw(state, batch)
        gpu, mg = round_fn(state, batch, draws)
        state_cpu = fedfits.init_state(init, ROBUST_K, s.fed_cfg,
                                       torch.Generator(),
                                       attacker=att["cpu"])
        step = _attacked_int8_step(sides["cpu"], state_cpu, cpu(batch),
                                   cpu(draws)) \
            if s.fed_cfg.compress == "int8" else 0.0
        host, mc = fedfits.make_round(s.model, s.fed_cfg, **kw(
            sides["cpu"]))(state_cpu, cpu(batch), cpu(draws))
        exact = ("team", "avail", "gated", "lost", "eff_epochs")
        if not torch.equal(mg["team"].cpu(), torch.from_numpy(row1["team"])):
            raise AssertionError(f"{name} round 1 rerun: not run_scenario's "
                                 "team")
    for k in exact:
        if not torch.equal(mg[k].cpu(), mc[k]):
            raise AssertionError(f"{name} round 1: CPU and card {k} differ")
    diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree.leaves(gpu.params), tree.leaves(host.params)))
    gt = float((gpu.gate_trust.cpu() - host.gate_trust).abs().max())
    print(f"[robust] {name} round 1 on the CPU port with the card's draws: "
          f"same {', '.join(exact)}; params max abs diff {diff:.3e}, "
          f"gate_trust {gt:.3e} (atol {ROUND1_ATOL + step:.3e})")
    if diff > ROUND1_ATOL + step or gt > ROUND1_ATOL:
        raise AssertionError(f"{name} round 1: CPU and card differ")


def _robustness():
    """Phase 6: returns the launch counts of the phase."""
    from repro_torch.comm.kernels import comm_codecs as cc
    from repro_torch.kernels import robust_agg as ra
    from repro_torch.kernels import robust_pipeline as rp
    t0 = time.perf_counter()
    for mod in (rp, cc, ra):
        mod.reset_launch_counts()
    _poisoning_defense()
    first = _robust_cells()
    counts = _counts()
    for name in REPLAY_CELLS:
        _replay_round1(name, first[name])
    k6 = {k: v for k, v in counts.items() if k.startswith("dequant_")}
    print(f"[robust] K6a-c launches {json.dumps(k6)} (the int8 cell is "
          "trimmed_mean: K6b mean and K6c need not launch)")
    _launched("robust", {k: v for k, v in counts.items()
                         if not k.startswith("dequant_")})
    print(f"[robust] phase 6 took {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phases 2c, 7 and 8: the transformer, serving, K8 and K9
# ---------------------------------------------------------------------------

def paged_work(lengths, page, maxp, hq, hkv, dh, pool_item, q_item):
    """Bytes and operations of K8 on these lengths: each live K and V row
    once (plus its two fp32 scales on int8 pools), q and the fp32 output;
    4 dh flops a (query head, live key) pair."""
    keys = int(lengths.clamp(0, maxp * page).sum())
    s = lengths.shape[0]
    scales = 2 * keys * hkv * 4 if pool_item == 1 else 0
    moved = 2 * keys * hkv * dh * pool_item + scales + s * hq * dh * (
        q_item + 4)
    return moved, 4 * keys * hq * dh


def band_pairs(s, window):
    """(query, key) pairs in the causal band of width ``window`` (0: all
    earlier keys)."""
    return sum(min(i + 1, window) if window else i + 1 for i in range(s))


def flash_work(b, hq, hkv, s, dh, window, item):
    """Bytes and operations of K9: q, k, v and o once; 4 dh flops a live
    (row, key) pair of each query head."""
    return ((2 * b * hq + 2 * b * hkv) * s * dh * item,
            4 * b * hq * dh * band_pairs(s, window))


def _attn_entry(name, source, replaces, err, kern, plain, lib, work, shape,
                ops_per_s=FP32_OPS_PER_S):
    bound_ms, bound_by = bound(*work, ops_per_s)
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": None, "max_abs_err": err,
             "ms": time_ms(kern), "plain_ms": time_ms(plain),
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": time_ms(lib) if lib else None, "shape": shape}
    print(f"[attention] {name} {shape}: {entry['ms']:.4f} ms, plain "
          f"{entry['plain_ms']:.4f} ms, library {entry['library_ms']}, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return entry


def _paged_inputs(seed, s, maxp, page, hq, hkv, dh):
    """Random pools, a permuted page table and ragged lengths: every page
    full, page + 1 rows, one row, an inactive slot, the rest random."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n = s * maxp + 3
    rand = lambda *shape: torch.randn(shape, generator=g, device=DEVICE)
    q = rand(s, hq, dh).bfloat16()
    kp, vp = rand(n, page, hkv, dh), rand(n, page, hkv, dh)
    table = torch.randperm(n, generator=g, device=DEVICE)[:s * maxp]
    lengths = torch.randint(1, maxp * page + 1, (s,), generator=g,
                            device=DEVICE)
    lengths[:4] = torch.tensor([maxp * page, page + 1, 1, 0])
    return (q, kp, vp, table.view(s, maxp).int().contiguous(),
            lengths.int())


def _atol(name, out, ref, atol):
    err = float((out - ref).abs().max())
    if not err <= atol:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e} > {atol})")
    return err


def _bf16_close(name, out, ref):
    """Within one bf16 ulp of the plain output plus K9_ATOL."""
    import torch
    o, r = out.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -126)))
                     - 7)
    err = float((o - r).abs().max())
    if not bool(((o - r).abs() <= ulp + K9_ATOL).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version beyond one bf16 ulp (max abs err "
                             f"{err:.3e})")
    return err


def _attention_kernels():
    """Phase 2c: K8 and K9 against their plain versions on the card, at the
    serving and forward shapes of phases 7-8 and at tiny-lm's head dim;
    returns the report entries."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels.flash_attention_ref import band_mask
    from repro_torch.models.attention import _paged_quant

    errs = {"paged_flash_decode": 0.0, "paged_flash_decode[int8]": 0.0,
            "flash_attention_fwd": 0.0}
    for page, maxp, hq, hkv, dh in ((SERVE_PAGE, SERVE_MAXP, 24, 8, 128),
                                    (8, 48, 8, 4, 64), (32, 12, 8, 4, 64)):
        q, kp, vp, table, lengths = _paged_inputs(page + dh, SERVE_SLOTS,
                                                  maxp, page, hq, hkv, dh)
        kq, ks = _paged_quant(kp)
        vq, vs = _paged_quant(vp)
        for name, pools, sc in (
                ("paged_flash_decode", (kp, vp), {}),
                ("paged_flash_decode[int8]", (kq, vq),
                 dict(k_scale=ks, v_scale=vs))):
            for qx in (q, q.float()):
                out = pd.paged_flash_decode(qx, *pools, table, lengths, **sc)
                ref = pd.paged_flash_decode_plain(qx, *pools, table, lengths,
                                                  **sc)
                errs[name] = max(errs[name], _atol(
                    f"{name} page {page} dh {dh}", out, ref, K8_ATOL))
                if float(out[3].abs().max()) != 0.0:
                    raise AssertionError(f"{name}: inactive slot not 0")
                again = pd.paged_flash_decode(qx, *pools, table, lengths,
                                              **sc)
                if not torch.equal(out, again):
                    raise AssertionError(f"{name}: two calls differ")
        torch.cuda.synchronize()
        print(f"[attention] K8 S={SERVE_SLOTS} Hq={hq} Hkv={hkv} dh={dh} "
              f"page {page} maxp {maxp}: fp32 and int8 pools, bf16 and fp32 "
              "queries agree with the plain version; the inactive slot is 0; "
              "two calls are bitwise equal")
    for b, hq, hkv, s, dh in ((2, 24, 8, FWD_SEQ, 128), (2, 8, 4, 384, 64),
                              (2, 8, 4, 200, 64)):
        g = torch.Generator(device=DEVICE).manual_seed(s + dh)
        qkv = [torch.randn(b, h, s, dh, generator=g, device=DEVICE)
               for h in (hq, hkv, hkv)]
        for window in (0, FWD_WINDOW):
            for dtype in (torch.bfloat16, torch.float32):
                x = [t.to(dtype) for t in qkv]
                out = fa.flash_attention_fwd(*x, causal=True, window=window)
                ref = fa.flash_attention_fwd_plain(*x, causal=True,
                                                   window=window)
                label = f"flash_attention_fwd {dtype} S={s} w={window}"
                errs["flash_attention_fwd"] = max(
                    errs["flash_attention_fwd"],
                    _bf16_close(label, out, ref) if dtype == torch.bfloat16
                    else _atol(label, out, ref, K9_ATOL))
        torch.cuda.synchronize()
        print(f"[attention] K9 B={b} Hq={hq} Hkv={hkv} S={s} dh={dh}: bf16 "
              f"and fp32, window 0 and {FWD_WINDOW}, agree with the plain "
              "version")

    report = []
    q, kp, vp, table, lengths = _paged_inputs(0, SERVE_SLOTS, SERVE_MAXP,
                                              SERVE_PAGE, 24, 8, 128)
    kq, ks = _paged_quant(kp)
    vq, vs = _paged_quant(vp)
    shape = {"S": SERVE_SLOTS, "Hq": 24, "Hkv": 8, "dh": 128,
             "page": SERVE_PAGE, "maxp": SERVE_MAXP,
             "keys": int(lengths.sum())}
    for name, pools, sc, item in (
            ("paged_flash_decode", (kp, vp), {}, 4),
            ("paged_flash_decode[int8]", (kq, vq),
             dict(k_scale=ks, v_scale=vs), 1)):
        report.append(_attn_entry(
            name, K8_SOURCE, K8_REPLACES, errs[name],
            lambda pools=pools, sc=sc: pd.paged_flash_decode(
                q, *pools, table, lengths, **sc),
            lambda pools=pools, sc=sc: pd.paged_flash_decode_plain(
                q, *pools, table, lengths, **sc), None,
            paged_work(lengths, SERVE_PAGE, SERVE_MAXP, 24, 8, 128, item, 2),
            shape))
        entry = report[-1]
        kern = lambda pools=pools, sc=sc: pd.paged_flash_decode(
            q, *pools, table, lengths, **sc)
        entry["device_ms"] = device_ms(kern)
        entry["host_us"] = host_us(kern)
        before = K8_BEFORE_MS[name]
        print(f"[attention] {name}: {entry['ms']:.4f} ms against the "
              f"earlier design's {before} ms ({before / entry['ms']:.1f}x); "
              f"device {entry['device_ms']:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms; wrapper {entry['host_us']:.2f} us "
              f"of host time a call ({HOST_CALLS} calls, no synchronize)")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=DEVICE).manual_seed(0)
    qkv = [torch.randn(2, h, FWD_SEQ, 128, generator=g, device=DEVICE)
           .bfloat16() for h in (24, 8, 8)]
    entries = []
    for window in (0, FWD_WINDOW):
        band = band_mask(FWD_SEQ, True, window, DEVICE)
        lib = (lambda: sdpa(*qkv, is_causal=True, enable_gqa=True)) \
            if not window else \
            (lambda band=band: sdpa(*qkv, attn_mask=band, enable_gqa=True))
        kern = lambda window=window: fa.flash_attention_fwd(
            *qkv, causal=True, window=window)
        entries.append(_attn_entry(
            "flash_attention_fwd", K9_SOURCE, K9_REPLACES,
            errs["flash_attention_fwd"], kern,
            lambda window=window: fa.flash_attention_fwd_plain(
                *qkv, causal=True, window=window), lib,
            flash_work(2, 24, 8, FWD_SEQ, 128, window, 2),
            {"B": 2, "Hq": 24, "Hkv": 8, "S": FWD_SEQ, "dh": 128,
             "dtype": "bfloat16", "window": window}, BF16_OPS_PER_S))
        entries[-1]["device_ms"] = device_ms(kern)
        entries[-1]["library_device_ms"] = device_ms(lib)
    for window, entry in zip((0, FWD_WINDOW), entries):
        before = K9_BEFORE_MS[window]
        print(f"[attention] flash_attention_fwd window {window}: "
              f"{entry['ms']:.4f} ms against the FMA design's "
              f"{before} ms ({before / entry['ms']:.1f}x); SDPA "
              f"{entry['library_ms']:.4f} ms; device {entry['device_ms']:.4f}"
              f" ms (SDPA {entry['library_device_ms']:.4f})")
    full, windowed = entries
    full["window"] = {k: windowed[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
        "device_ms", "library_device_ms")}
    report.append(full)
    _k9_replay_check()
    return report


def _k9_replay_check():
    """K9 captured in a CUDA graph (its TMA maps passed by value), then
    replayed on new contents of its input buffers: bitwise its eager call
    on those contents, bf16 and fp32, at the serving prefill's head
    shape."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=DEVICE).manual_seed(4)
    for dtype in (torch.bfloat16, torch.float32):
        qkv = [torch.randn(1, h, SERVE_PROMPT, 128, generator=g,
                           device=DEVICE, dtype=dtype) for h in (24, 8, 8)]
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fa.flash_attention_fwd(*qkv)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = fa.flash_attention_fwd(*qkv)
        torch.cuda.current_stream().wait_stream(stream)
        for _ in range(3):
            for t in qkv:
                t.copy_(torch.randn(t.shape, generator=g, device=DEVICE,
                                    dtype=dtype))
            graph.replay()
            if not torch.equal(out, fa.flash_attention_fwd(*qkv)):
                raise AssertionError(f"K9 {dtype}: the replay is not the "
                                     "eager call")
    torch.cuda.synchronize()
    print(f"[attention] K9 captured once and replayed on new inputs "
          f"(1, 24/8, {SERVE_PROMPT}, 128), bf16 and fp32: bitwise the "
          "eager call")


def _admit(engine, cache, st, reqs):
    """Admit ``reqs`` in order; returns (cache, st, the slot of each)."""
    import torch
    slots = []
    for r in reqs:
        prompt = torch.zeros(engine.scfg.prompt_pad, dtype=torch.int64)
        prompt[:len(r.tokens)] = torch.tensor(r.tokens)
        cache, st, out = engine._admit(engine.params, cache, st,
                                       prompt.to(engine.device),
                                       len(r.tokens), r.max_new, r.req_id)
        slots.append(int(out["slot"]))
    return cache, st, slots


def _step_logits(engine, cache, st, table=None, length=None):
    """fp32 (S, V) logits of the decode step's own forward call on this
    state; ``table`` / ``length`` stand in for the state's to model a
    paging fault."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serve import engine as serve_engine
    table = st.table if table is None else table
    length = st.length if length is None else length
    view = serve_engine._with_ctx(cache, table, length, st.active,
                                  torch.zeros_like(st.length))
    logits, _, _ = transformer.forward(engine.params, engine.cfg,
                                       tokens=st.tok,
                                       positions=st.length[:, None],
                                       cache=view)
    return logits[:, 0].float()


def _first_step_logits(engine, reqs, warm=(), faults=False):
    """The first decode-step logits of ``reqs``, one row each in order.

    With ``warm``, those requests are admitted first and decoded until
    len(reqs) slots are free again, so ``reqs`` land in recycled slots and
    pages (stale rows of the warm requests past their lengths) beside live
    requests.  With ``faults``, also returns the logits under two paging
    faults of that state: each request reading the first page of the next
    one ("page"), and each reading one row past its length ("row")."""
    import torch
    cache, st = engine.fresh_state()
    if warm:
        cache, st, _ = _admit(engine, cache, st, warm)
        free = engine.scfg.max_slots - len(warm)
        while free < len(reqs):
            cache, st, out = engine._decode(engine.params, cache, st)
            free = engine.scfg.max_slots - int(st.active.sum())
    cache, st, slots = _admit(engine, cache, st, reqs)
    rows = torch.tensor(slots, device=st.active.device)
    sound = _step_logits(engine, cache, st)[rows]
    if not faults:
        return sound
    table = st.table.clone()
    table[rows, 0] = st.table[rows.roll(-1), 0]
    length = torch.where(torch.isin(torch.arange(
        st.length.shape[0], device=rows.device), rows), st.length + 1,
        st.length)
    return sound, {"page": _step_logits(engine, cache, st, table=table)[rows],
                   "row": _step_logits(engine, cache, st,
                                       length=length)[rows]}


def _logits_close(label, out, ref, rel, control=False):
    """max |out - ref| <= tol = rel x max |ref|, and the same argmax in every
    row whose top-2 gap in ``ref`` exceeds tol.  Raises unless that holds,
    or, for a ``control`` (a fault the check must see), unless it fails."""
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    tol = rel * scale
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    same = out.argmax(-1) == ref.argmax(-1)
    ok = err <= tol and bool(same[clear].all())
    print(f"[{label}] first decode-step logits max abs diff {err:.3e} "
          f"({err / scale:.5f} of max |logit| {scale:.3f}; tol {rel:.5f}); "
          f"argmax equal in {int(same.sum())}/{same.numel()} rows "
          f"({int(clear.sum())} with a clear top-2 gap): "
          f"{'holds' if ok else 'fails'}"
          f"{' (a control: must fail)' if control else ''}")
    if ok == control:
        raise AssertionError(f"{label}: the logits check "
                             f"{'holds' if ok else 'fails'}")
    return err


def _step_ms(stats):
    ms = sorted(1e3 * t for t in stats["step_s"])
    return ms[len(ms) // 2], ms[0], ms[-1]


def _serve_line(label, stats, smi):
    med, lo, hi = _step_ms(stats)
    print(f"[serve] {label}: {stats['tokens']} tokens in {stats['steps']} "
          f"decode steps, {stats['wall_s']:.3f} s, {stats['tokens_per_s']:.1f}"
          f" tokens/s; decode step ms median {med:.3f} (min {lo:.3f}, max "
          f"{hi:.3f}) | {smi}")


def _complete(label, results, stats, reqs, scfg):
    for r in reqs:
        if len(results[r.req_id]) != r.max_new:
            raise AssertionError(f"{label}: req {r.req_id} emitted "
                                 f"{len(results[r.req_id])} of {r.max_new}")
    if stats["free_pages_end"] != scfg.total_pages:
        raise AssertionError(f"{label}: {stats['free_pages_end']} of "
                             f"{scfg.total_pages} pages back in the pool")


def _eager_admission_engine(cfg, scfg, params, eager_decode=False):
    """A ServeEngine whose ``run`` admits by ``_admit`` called eagerly, as
    the engine did before its admission was captured (and, with
    ``eager_decode``, decodes by ``_decode`` eagerly a step, as before its
    decode step was): the timing baselines."""
    from repro_torch.core.driver import copy_into
    from repro_torch.serve import ServeEngine
    from repro_torch.serve import engine as serve_engine

    class Eager(ServeEngine):
        def _admission(self, cache, st, r):
            self._load_request(r)
            st2, out = self._admit_static(cache, st)
            host = serve_engine._to_host(out)
            copy_into(st, st2)
            return host

        def _step(self, cache, st):
            if not eager_decode:
                return super()._step(cache, st)
            _, st2, out = self._decode(self.params, cache, st)
            host = serve_engine._to_host(out)
            copy_into(st, st2)
            return host

    return Eager(cfg, scfg, params)


def _same_serving_state(a, b):
    """The fields of two engines' own pools and SlotStates that differ
    bitwise (the counter column and the generator's state included), and
    whether the pools' drop page differs.  The drop page (the last) takes
    every inactive slot's append at once, duplicate rows in no set order,
    and nothing reads it."""
    import torch
    (ca, sa), (cb, sb) = a._static, b._static
    bad = [f for f in sa._fields if f not in ("tele", "gen")
           and not torch.equal(getattr(sa, f), getattr(sb, f))]
    bad += [f"tele.{k}" for k in sa.tele
            if not torch.equal(sa.tele[k], sb.tele[k])]
    if not torch.equal(sa.gen.get_state(), sb.gen.get_state()):
        bad.append("gen")
    for n in ca:
        for k in ca[n]:
            x, y = ca[n][k], cb[n][k]
            pages = (x != y).flatten(2).any(-1).any(0).nonzero().flatten()
            if pages.numel():
                bad.append(f"{n}.{k} pages {pages.tolist()[:8]}")
    drop = x.shape[1] - 1
    real = [e for e in bad if " pages " not in e
            or e.split(" pages ")[1] != f"[{drop}]"]
    return real, len(real) < len(bad)


def _admission_launches(engine, reqs):
    """Launches from the host an admission (CUDA runtime kernel, copy,
    memset and graph-launch calls, as torch.profiler names them), over
    ``reqs`` admitted into the engine's own reset state."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_round import HOST_LAUNCHES
    cache, st = engine._reset()
    engine._admission(cache, st, reqs[0])        # the warm-up / capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for r in reqs[1:]:
            engine._admission(cache, st, r)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
               and any(k in e.name for k in HOST_LAUNCHES)) \
        / (len(reqs) - 1)


def _admission_phase(engine, cfg, params, reqs, results, stats, smi):
    """Phase 7's admission checks: the 48 requests again through an engine
    whose admission runs eagerly (its decode step still replayed), the
    same tokens, pools and SlotState (counter column and generator too)
    bitwise; continuous tokens/s and the admission's host-clock wall under
    both, and their launches from the host an admission; then 12
    requests at temperature 0.7, captured against eager admission,
    bitwise."""
    import statistics
    import torch
    from repro_torch.launch.serve import draw_requests
    from repro_torch.serve import ServeConfig, ServeEngine
    scfg = engine.scfg
    eager = _eager_admission_engine(cfg, scfg, params)
    eager.run(draw_requests(1, SERVE_PROMPT, 2, 2, cfg.vocab_size, seed=9))
    e_results, e_stats = eager.run(reqs)
    bad, drop = _same_serving_state(engine, eager)
    bad += ["tokens"] if e_results != results else []
    med = lambda st: statistics.median(st["admit_s"]) * 1e3
    print(f"[admit] continuous, 48 requests: admission replayed "
          f"{stats['tokens_per_s']:.1f} tokens/s, {stats['wall_s']:.3f} s, "
          f"admission median {med(stats):.3f} ms (min "
          f"{min(stats['admit_s']) * 1e3:.3f}, max "
          f"{max(stats['admit_s']) * 1e3:.3f}); eager admission "
          f"{e_stats['tokens_per_s']:.1f} tokens/s, {e_stats['wall_s']:.3f}"
          f" s, admission median {med(e_stats):.3f} ms; "
          f"{'bitwise (tokens, pools, SlotState)' if not bad else bad}"
          f"{' but the drop page' if drop else ''} | {smi}")
    if bad:
        raise AssertionError(f"the replayed admission is not the eager one: "
                             f"{bad}")
    few = reqs[:6]
    n_eager = _admission_launches(eager, few)
    n_replay = _admission_launches(engine, few)
    print(f"[admit] launches from the host an admission: eager "
          f"{n_eager:.0f}, replayed {n_replay:.0f}")
    del eager
    torch.cuda.empty_cache()
    sub = draw_requests(12, SERVE_PROMPT, 8, 64, cfg.vocab_size, seed=1)
    warm = draw_requests(1, SERVE_PROMPT, 2, 2, cfg.vocab_size, seed=9)
    hot = ServeConfig(**SUB_CFG, attn="pallas", temperature=0.7)
    a, b = ServeEngine(cfg, hot, params), _eager_admission_engine(cfg, hot,
                                                                  params)
    a.run(warm)
    res_a, _ = a.run(sub)
    res_b, _ = b.run(sub)
    bad, drop = _same_serving_state(a, b)
    bad += ["tokens"] if res_a != res_b else []
    print(f"[parity] serve T=0.7: 12 requests, admission replayed vs eager: "
          f"{'bitwise (tokens, pools, SlotState)' if not bad else bad}"
          f"{' but the drop page' if drop else ''}")
    if bad:
        raise AssertionError(f"T=0.7: the replayed admission is not the "
                             f"eager one: {bad}")
    del a, b
    torch.cuda.empty_cache()


def _serving_telemetry(engine, reqs, results):
    """Phase 7's telemetry: the 48 requests with a Telemetry (JSONL and
    trace), the same tokens, the artifacts through
    ``repro_torch.obs.check``."""
    from repro_torch.obs import JsonlSink, Telemetry
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    jsonl, trace = str(out_dir / "serve.jsonl"), \
        str(out_dir / "serve_trace.json")
    tel = Telemetry(sinks=[JsonlSink(jsonl)], trace_path=trace,
                    run_name="chip_smoke serve")
    t_results, t_stats = engine.run(reqs, telemetry=tel)
    summary = tel.finish()
    if t_results != results or summary["rows"] != t_stats["steps"]:
        raise AssertionError("serving with telemetry: other tokens or rows")
    print(f"[serve] telemetry on, 48 requests: {summary['rows']} rows, the "
          f"same tokens, {t_stats['tokens_per_s']:.1f} tokens/s; "
          f"{_obs_check('serve', jsonl, trace)}")


def _admit_own(engine, reqs):
    """``reqs`` admitted into the engine's own state, reset first."""
    from repro_torch.core.driver import copy_into
    cache, st = engine._reset()
    _, st2, _ = _admit(engine, cache, st, reqs)
    copy_into(st, st2)
    return cache, st


def _steady_decode(engine, reqs, replay):
    """Steady decode steps at full occupancy: ``reqs`` admitted, 3 warm-up
    steps, 10 timed on the host clock (each ending in a synchronize), then
    3 traced: device busy ms, idle share, K8's share of device time and the
    launches from the host.  ``replay``: the engine's captured step on its
    own state, else ``_decode`` called eagerly on a fresh one, whose trace
    also names the copy kernels by the shapes of the ``aten::copy_`` that
    launch them.  Returns the step median."""
    import statistics
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_round import HOST_LAUNCHES, busy_ms
    if replay:
        cache, st = _admit_own(engine, reqs)
        step = lambda: engine._step(cache, st)
    else:
        box = list(_admit(engine, *engine.fresh_state(), reqs)[:2])

        def step():
            box[0], box[1], _ = engine._decode(engine.params, *box)
    walls = []
    for i in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= 3:
            walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=not replay) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        traced = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    host = sum(1 for e in events if e.device_type == DeviceType.CPU
               and any(k in e.name for k in HOST_LAUNCHES))
    busy = busy_ms(dev)
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.self_device_time_total / 1e3
    k8 = sum(ms for n, ms in by_name.items() if "pd_kernel" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    med = statistics.median(walls)
    print(f"[serve] steady decode at {len(reqs)} slots, "
          f"{'replayed graph' if replay else 'eager _decode'}: step ms "
          f"median {med:.3f} (min {min(walls):.3f}, max {max(walls):.3f}); "
          f"3 traced steps: wall {traced:.3f} ms, device busy {busy:.3f} "
          f"ms (kernels summed {sum(by_name.values()):.3f}), idle share "
          f"{1 - busy / traced:.3f}, K8 {k8:.3f} ms "
          f"({k8 / max(busy, 1e-9):.3f} of device time), {len(dev)} device "
          f"events, {host / 3:.0f} launches from the host a step")
    for name, ms in top:
        print(f"[serve]   {ms:8.3f} ms  {name[:90]}")
    if not replay:
        copies = sorted((e for e in prof.key_averages(
            group_by_input_shape=True) if e.key == "aten::copy_"),
            key=lambda e: -e.device_time_total)
        total = sum(e.device_time_total for e in copies) / 1e3
        print(f"[serve]   aten::copy_ in 3 steps: {total:.3f} ms device, "
              f"{sum(e.count for e in copies)} calls; by shapes (dst, src):")
        for e in copies[:8]:
            print(f"[serve]     {e.device_time_total / 1e3:8.3f} ms  "
                  f"x{e.count:<5} {e.input_shapes[:2]}")
    return med


def _clone_serve(cache, st):
    """A copy of a serving state, its generator at the same place."""
    import torch
    gen = torch.Generator(DEVICE)
    gen.set_state(st.gen.get_state())
    return ({b: {k: v.clone() for k, v in blk.items()}
             for b, blk in cache.items()},
            st._replace(gen=gen, tele={k: v.clone()
                                       for k, v in st.tele.items()},
                        **{f: getattr(st, f).clone() for f in st._fields
                           if f not in ("gen", "tele")}))


def _serve_parity(engine, cfg, params, reqs):
    """Phase 7's parity: SERVE_PARITY_STEPS replayed decode steps against
    ``_decode`` called eagerly on two copies of the same state (the second
    measures the eager loop's own spread): tokens, lengths and pools
    bitwise, at temperature 0 and 0.7."""
    import torch
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve import engine as serve_engine
    from repro_torch.launch.serve import draw_requests
    for temp in (0.0, 0.7):
        eng = engine if temp == 0.0 else ServeEngine(
            cfg, ServeConfig(**SERVE_CFG, attn="pallas", temperature=temp),
            params)
        if eng._graph is None:                    # the first run captures
            eng.run(draw_requests(1, SERVE_PROMPT, 3, 3, cfg.vocab_size,
                                  seed=9))
        cache, st = _admit_own(eng, reqs)
        copies = [list(_clone_serve(cache, st)) for _ in range(2)]
        tok = {"replay": [], "eager": [], "eager'": []}
        for _ in range(SERVE_PARITY_STEPS):
            tok["replay"].append(eng._step(cache, st)["next"])
            for name, c in zip(("eager", "eager'"), copies):
                _, st2, out = eng._decode(eng.params, *c)
                tok[name].append(serve_engine._to_host(out)["next"])
                c[1] = st2

        def diff(a, b):
            bad = [k for k in ("tok", "length", "active", "free")
                   if not torch.equal(getattr(a[1], k), getattr(b[1], k))]
            bad += [f"{n}.{k}" for n in a[0] for k in a[0][n]
                    if not torch.equal(a[0][n][k], b[0][n][k])]
            return bad
        spread = diff(copies[1], copies[0]) + (
            ["tokens"] if tok["eager'"] != tok["eager"] else [])
        err = diff((cache, st), copies[0]) + (
            ["tokens"] if tok["replay"] != tok["eager"] else [])
        print(f"[parity] serve T={temp}: {SERVE_PARITY_STEPS} replayed "
              f"decode steps vs _decode eagerly on a copy: "
              f"{'bitwise (tokens, lengths, pools)' if not err else err}; "
              f"two eager copies {'bitwise' if not spread else spread}")
        if err and not set(err) <= set(spread):
            raise AssertionError(f"serve T={temp}: the replayed step is not "
                                 f"the eager one ({err})")
        del copies, cache, st, eng
        torch.cuda.empty_cache()


def _serving(smi, box):
    """Phase 7: minitron-4b at full width and depth behind the serving
    engines.  Leaves the params in ``box`` for phase 8; returns the launch
    counts of the K8 paths."""
    import types
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.launch.serve import draw_requests, run_dense
    from repro_torch.models import transformer
    from repro_torch.models.model import build
    from repro_torch.serve import ServeConfig, ServeEngine, kv_bytes_read
    from repro_torch.serve.scheduler import pages_needed

    t0 = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = transformer.cast_params(
        build(cfg).init(torch.Generator(device=DEVICE).manual_seed(0)), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {n_params:,} parameters drawn in fp32 on the "
          f"card and cast once to {cfg.dtype} "
          f"({torch.cuda.max_memory_allocated() / 1e9:.2f} GB peak) in "
          f"{time.perf_counter() - t0:.1f} s")
    scfg = ServeConfig(**SERVE_CFG, attn="pallas")
    engine = ServeEngine(cfg, scfg, params)
    engine.run(draw_requests(1, SERVE_PROMPT, 2, 2, cfg.vocab_size, seed=9))
    reqs = draw_requests(48, SERVE_PROMPT, 16, 256, cfg.vocab_size, seed=0)
    counts = {}
    pd.reset_launch_counts()
    results, stats = engine.run(reqs)
    counts["paged_flash_decode"] = pd.launch_counts()["paged_flash_decode"]
    _complete("continuous", results, stats, reqs, scfg)
    if counts["paged_flash_decode"] != cfg.n_layers * stats["steps"]:
        raise AssertionError(f"K8 launched {counts['paged_flash_decode']} "
                             f"times in {stats['steps']} decode steps")
    _serve_line(f"continuous, 48 requests, K8 x{counts['paged_flash_decode']}"
                f" ({cfg.n_layers} a step), the captured decode step and "
                "admission replayed", stats, smi)
    t_adm = time.perf_counter()
    _admission_phase(engine, cfg, params, reqs, results, stats, smi)
    _serving_telemetry(engine, reqs, results)
    print(f"[admit] admission and telemetry checks took "
          f"{time.perf_counter() - t_adm:.1f} s")
    eager = _eager_admission_engine(cfg, scfg, params, eager_decode=True)
    eager.run(draw_requests(1, SERVE_PROMPT, 2, 2, cfg.vocab_size, seed=9))
    e_results, e_stats = eager.run(reqs)
    del eager
    same = sum(a == b for r in reqs for a, b in zip(results[r.req_id],
                                                    e_results[r.req_id]))
    _serve_line(f"continuous, 48 requests, _decode and _admit eagerly "
                f"({same} of {stats['tokens']} tokens as the replayed "
                "steps')", e_stats, smi)
    if e_results != results:
        raise AssertionError("the eager and the replayed steps emitted "
                             "other tokens")

    # the subset runs over fewer slots than requests, so that continuous
    # admits mid-run into recycled slots and pages and fixed does not
    sub = draw_requests(12, SERVE_PROMPT, 8, 64, cfg.vocab_size, seed=1)
    sub_cfg = ServeConfig(**SUB_CFG, attn="pallas")
    sub_engine = ServeEngine(cfg, sub_cfg, params)
    cont, s_cont = sub_engine.run(sub)
    fixed, s_fixed = sub_engine.run(sub, continuous=False)
    _complete("continuous subset", cont, s_cont, sub, sub_cfg)
    _complete("fixed", fixed, s_fixed, sub, sub_cfg)
    if not s_cont["steps"] < s_fixed["steps"]:
        raise AssertionError("continuous admitted nothing mid-run: "
                             f"{s_cont['steps']} steps, fixed "
                             f"{s_fixed['steps']}")
    if cont != fixed:
        raise AssertionError("continuous and fixed engines disagree")
    _serve_line(f"continuous, 12 requests over {SUB_SLOTS} slots", s_cont,
                smi)
    _serve_line(f"fixed, 12 requests over {SUB_SLOTS} slots (same tokens)",
                s_fixed, smi)
    ref_engine = ServeEngine(cfg, ServeConfig(**SUB_CFG, attn="ref"), params)
    ref, s_ref = ref_engine.run(sub)
    _complete("ref", ref, s_ref, sub, sub_cfg)
    same = sum(a == b for r in sub for a, b in zip(ref[r.req_id],
                                                   cont[r.req_id]))
    _serve_line(f"ref attention, 12 requests ({same} of "
                f"{sum(r.max_new for r in sub)} tokens as K8's)", s_ref, smi)
    # first decode-step logits of 8 requests: the ref engine's from a fresh
    # state against K8's from a fresh state and from one where they land
    # in recycled slots and pages beside 8 live requests, and under two
    # paging faults of that state, which the check must see
    first = sub[:SUB_SLOTS]
    warm = draw_requests(SERVE_SLOTS, SERVE_PROMPT, 2, 32, cfg.vocab_size,
                         seed=3)
    ref_logits = _first_step_logits(ref_engine, first)
    _logits_close("serve K8 vs ref", _first_step_logits(sub_engine, first),
                  ref_logits, SERVE_LOGIT_REL)
    mixed, faulted = _first_step_logits(engine, first, warm=warm,
                                        faults=True)
    _logits_close("serve K8 in recycled slots vs ref", mixed, ref_logits,
                  SERVE_LOGIT_REL)
    _logits_close("serve K8, each request reading the next one's first "
                  "page", faulted["page"], ref_logits, SERVE_LOGIT_REL,
                  control=True)
    _logits_close("serve K8, each request reading one row past its length",
                  faulted["row"], ref_logits, SERVE_LOGIT_REL, control=True)
    del ref_engine, sub_engine

    scfg8 = ServeConfig(**SUB_CFG, attn="pallas", kv_int8=True)
    pd.reset_launch_counts()
    res8, s8 = ServeEngine(cfg, scfg8, params).run(sub)
    counts["paged_flash_decode[int8]"] = \
        pd.launch_counts()["paged_flash_decode[int8]"]
    _complete("int8", res8, s8, sub, scfg8)
    pages = sum(pages_needed(len(r.tokens), r.max_new, sub_cfg) for r in sub)
    ratio = kv_bytes_read(cfg, sub_cfg, pages) / kv_bytes_read(cfg, scfg8,
                                                               pages)
    if ratio < 3.0:
        raise AssertionError(f"int8 reads only {ratio:.2f}x fewer KV bytes")
    same8 = sum(a == b for r in sub for a, b in zip(res8[r.req_id],
                                                    cont[r.req_id]))
    _serve_line(f"int8 KV, 12 requests, K8[int8] x"
                f"{counts['paged_flash_decode[int8]']}, {ratio:.2f}x fewer KV "
                f"bytes ({same8} tokens as fp32 KV's)", s8, smi)
    args = types.SimpleNamespace(max_slots=16, prompt_len=SERVE_PROMPT,
                                 gen_max=64, requests=12, temperature=0.0)
    dense = run_dense(build(cfg), cfg, args, params,
                      torch.Generator(device=DEVICE).manual_seed(1))
    print(f"[serve] dense full cache, 12 requests padded to 64: "
          f"{dense['tokens']} tokens in {dense['wall_s']} s, "
          f"{dense['tokens_per_s']} tokens/s | {smi}")
    _steady_decode(engine, reqs[:SERVE_SLOTS], replay=False)
    _steady_decode(engine, reqs[:SERVE_SLOTS], replay=True)
    _serve_parity(engine, cfg, params, reqs[:SERVE_SLOTS])
    print(f"[serve] phase 7 took {time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    box.append(params)
    return counts


def _leaves(tree_):
    from repro_torch import tree
    return tree.leaves(tree_)


def _forward(box, smi):
    """Phase 8: ``Model.forward`` at full width and depth on (2, 1024)
    tokens through K9, against the plain attention; a 2-layer fp32 cut;
    round 1 of serving on the CPU port.  Takes the params out of ``box``
    and frees them.  Returns K9's launch count on the forward path."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import draw_requests
    from repro_torch.models import transformer
    from repro_torch.models.model import build
    from repro_torch.serve import ServeConfig, ServeEngine

    t0 = time.perf_counter()
    params = box.pop()
    cfg = get_config(SERVE_ARCH).replace(attn_impl="pallas")
    toks = torch.randint(0, cfg.vocab_size, (2, FWD_SEQ), device=DEVICE,
                         generator=torch.Generator(device=DEVICE)
                         .manual_seed(2))
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits = build(cfg).forward(params, {"tokens": toks})
    torch.cuda.synchronize()
    fwd_ms = 1e3 * (time.perf_counter() - t1)
    k9 = fa.launch_counts()["flash_attention_fwd"]
    if k9 != cfg.n_layers:
        raise AssertionError(f"K9 launched {k9} times in a "
                             f"{cfg.n_layers}-layer forward")
    if tuple(logits.shape) != (2, FWD_SEQ, cfg.padded_vocab) or not bool(
            torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError("Model.forward: logits not finite or misshapen")
    del logits
    hid, hid_ms = {}, {}
    for impl in ("pallas", "xla"):
        t1 = time.perf_counter()
        hid[impl] = transformer.forward(
            params, cfg.replace(attn_impl=impl), tokens=toks,
            collect_logits=False)[0].float()
        torch.cuda.synchronize()
        hid_ms[impl] = 1e3 * (time.perf_counter() - t1)
    # a control the check must see: K9 dropping the keys more than
    # FWD_SEQ - 128 rows back (one key block for the last 128 rows)
    hid["fault"] = transformer.forward(
        params, cfg.replace(sliding_window=FWD_SEQ - 128), tokens=toks,
        collect_logits=False)[0].float()
    scale = float(hid["xla"].abs().max())
    for impl, control in (("pallas", False), ("fault", True)):
        err = float((hid[impl] - hid["xla"]).abs().max())
        ok = err <= FWD_HIDDEN_REL * scale
        print(f"[forward] {impl}: last hidden vs attn_impl=xla max abs diff "
              f"{err:.3e} ({err / scale:.5f} of max |h| {scale:.3f}; tol "
              f"{FWD_HIDDEN_REL:.5f}): {'holds' if ok else 'fails'}"
              f"{' (a control: must fail)' if control else ''}")
        if ok == control:
            raise AssertionError(f"forward {impl} vs plain: the check "
                                 f"{'holds' if ok else 'fails'}")
    print(f"[forward] {cfg.name} Model.forward (2, {FWD_SEQ}) {cfg.dtype}, "
          f"K9 x{k9}: logits finite; host-clock ms: Model.forward "
          f"{fwd_ms:.1f}, hidden only {hid_ms['pallas']:.1f} (K9) vs "
          f"{hid_ms['xla']:.1f} (plain attention) | {smi}")
    del hid, params
    torch.cuda.empty_cache()
    print(f"[forward] params freed: {torch.cuda.memory_allocated() / 1e9:.2f}"
          " GB still allocated")

    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    p2 = build(cfg2).init(torch.Generator(device=DEVICE).manual_seed(3))
    h2 = {impl: transformer.forward(p2, cfg2.replace(attn_impl=impl),
                                    tokens=toks, collect_logits=False)[0]
          for impl in ("pallas", "xla")}
    err2 = float((h2["pallas"] - h2["xla"]).abs().max())
    if err2 > FWD_FP32_ATOL:
        raise AssertionError(f"2-layer fp32 forward: K9 vs plain {err2:.3e}")
    print(f"[forward] 2-layer fp32 cut: last hidden K9 vs attn_impl=xla max "
          f"abs diff {err2:.3e} (tol {FWD_FP32_ATOL})")
    del h2
    scfg = ServeConfig(**SERVE_CFG, attn="pallas")
    reqs = draw_requests(4, SERVE_PROMPT, 8, 64, cfg.vocab_size, seed=1)
    on_card = _first_step_logits(ServeEngine(cfg2, scfg, p2), reqs)
    p2cpu = tree.map(lambda t: t.cpu(), p2)
    del p2
    torch.cuda.empty_cache()
    on_cpu = _first_step_logits(ServeEngine(cfg2, scfg, p2cpu,
                                            device="cpu"), reqs)
    _logits_close("serve round 1 on the CPU port", on_card.cpu(), on_cpu,
                  ROUND1_LOGIT_REL)
    print(f"[forward] phase 8 took {time.perf_counter() - t0:.1f} s")
    return k9


# ---------------------------------------------------------------- phase 9 --
def _pod_train(*extra):
    """``launch/train.py``'s main path in this process -> (state, rows)."""
    from repro_torch.launch import train
    return train.main(["--arch", POD_ARCH, "--clients", str(POD_C),
                       "--global-batch", str(POD_GB), "--seq", str(POD_SEQ),
                       "--robust", "per_client", "--device", DEVICE,
                       *extra])


def _pod_launches():
    """The pod path's kernel counters (K1-K3, K6a-c), by name."""
    from repro_torch.comm.kernels import comm_codecs as cc
    from repro_torch.kernels import robust_pipeline as rp
    return {**rp.launch_counts(), **cc.launch_counts()}


def _pod_reset():
    from repro_torch.comm.kernels import comm_codecs as cc
    from repro_torch.kernels import robust_pipeline as rp
    rp.reset_launch_counts()
    cc.reset_launch_counts()


def _same_state(label, a, b):
    """Two pod states bit for bit: every tensor, and the generators'
    states."""
    import torch
    from repro_torch import tree
    la, lb = tree.leaves(a), tree.leaves(b)
    if len(la) != len(lb):
        raise AssertionError(f"{label}: the states differ in structure")
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        if isinstance(x, torch.Tensor) and not (
                x.dtype == y.dtype and x.shape == y.shape
                and torch.equal(x.cpu(), y.cpu())):
            raise AssertionError(f"{label}: state leaf {i} differs")


def _same_rows(label, a, b, host=("wall_ms", "chunk_ms")):
    """Two histories bit for bit, but the host clocks."""
    import numpy as np
    if len(a) != len(b):
        raise AssertionError(f"{label}: {len(a)} rows against {len(b)}")
    for ra, rb in zip(a, b):
        keys = set(ra) - set(host)
        if keys != set(rb) - set(host):
            raise AssertionError(f"{label}: the rows' keys differ")
        for k in keys:
            x, y = np.asarray(ra[k]), np.asarray(rb[k])
            if (x.dtype, x.shape, x.tobytes()) != (y.dtype, y.shape,
                                                    y.tobytes()):
                raise AssertionError(f"{label}: {k} differs at step "
                                     f"{ra['step']}")


def _pod_entry_point(out):
    """Phase 9: the schedule through ``launch/train.py``; returns the
    launches of K1-K3 and K6a-c on this path, by name."""
    total = {}
    bytes_up = _pod_int8_bytes()
    for agg, comp, steps in POD_SCHEDULE:
        _pod_reset()
        t0 = time.perf_counter()
        _, rows = _pod_train("--steps", str(steps), "--aggregator", agg,
                             "--compress", comp)
        got = {k: n for k, n in _pod_launches().items() if n}
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        want = (["dequant_gate_partials"] if comp == "int8"
                else ["cosine_gate_partials"])
        want.append(("dequant_" if comp == "int8" else "")
                    + {"trimmed_mean": "gated_combine[trimmed]",
                       "median": "gated_combine[median]"}.get(
                           agg, "gated_combine[mean]"))
        if agg == "krum":
            want.append("dequant_pairwise_gram" if comp == "int8"
                        else "pairwise_gram")
        for k in want:
            if got.get(k) != steps:
                raise AssertionError(f"[pod] {agg}/{comp}: {k} launched "
                                     f"{got.get(k, 0)} times in {steps} "
                                     "steps")
        losses = [float(r["loss"]) for r in rows]
        print(f"[pod] train.main --aggregator {agg} --compress {comp}: "
              f"{steps} steps in {time.perf_counter() - t0:.1f} s, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, launches {got}")
        if agg == "fedavg" and comp == "none":
            if not losses[-1] < losses[0]:
                raise AssertionError("[pod] the loss did not fall over "
                                     f"{steps} steps: {losses}")
            out["fedavg_loss"] = [losses[0], losses[-1]]
            # chunks of 8: steps 8-15 are one chunk replayed whole
            out["scan_chunk_step_ms"] = float(rows[min(8, steps - 1)][
                "wall_ms"])
        if comp == "int8":
            got_b = float(rows[0]["comm_bytes_up"])
            out["comm_bytes_up"] = got_b
            if got_b != bytes_up:
                raise AssertionError(f"[pod] comm_bytes_up {got_b} != "
                                     f"{bytes_up}")
            print(f"[pod] comm_bytes_up {got_b:.0f} B a step = float32("
                  f"C x (N + 4 NQ)) = {bytes_up:.0f}")
    return total


def _pod_determinism(out):
    """Phase 9 under deterministic algorithms: scan bitwise python through
    the entry point, the mesh-sharded aggregation bitwise the unsharded one
    at world size 1, and a run resumed from its step-4 checkpoint bitwise
    the uninterrupted run."""
    import shutil
    import tempfile
    import torch
    steps, chunk = POD_PARITY
    runs = {}
    for drv in ("python", "scan"):
        _pod_reset()
        st, rows = _pod_train("--steps", str(steps), "--chunk-rounds",
                              str(chunk), "--driver", drv)
        runs[drv] = (st, rows, _pod_launches())
    _same_state("[parity] pod scan vs python", runs["scan"][0],
                runs["python"][0])
    _same_rows("[parity] pod scan vs python", runs["scan"][1],
               runs["python"][1])
    if runs["scan"][2] != runs["python"][2]:
        raise AssertionError(f"[parity] pod launches differ: {runs}")
    launched = {k: n for k, n in runs["scan"][2].items() if n}
    out["scan_launches"] = launched
    print(f"[parity] pod {steps} steps, chunks of {chunk}: scan vs python "
          f"bitwise (params, opt state, fed state, every history key); "
          f"launches under both {launched}")

    for agg, comp in (("trimmed_mean", "none"), ("fedavg", "int8")):
        _pod_mesh_parity(agg, comp)

    root = tempfile.mkdtemp(prefix="pod_ckpt_")
    try:
        n, at = POD_CKPT
        args = ("--steps", str(n), "--ckpt-dir", root, "--ckpt-every",
                str(at))
        st_a, rows_a = _pod_train(*args)
        shutil.rmtree(f"{root}/step_{n:08d}")
        st_b, rows_b = _pod_train(*args)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _same_rows("[ckpt] pod resume", rows_a[at:], rows_b)
    _same_state("[ckpt] pod resume", st_a, st_b)
    print(f"[ckpt] pod: restored at step {at}, steps {at}-{n - 1} and the "
          f"final state bitwise the uninterrupted run's")


def _pod_state(cfg, fed, tc, dev, mesh=None, seed=0):
    import torch
    from repro_torch.core import pod
    from repro_torch.models import transformer
    from repro_torch.optim import optimizers
    params = transformer.init_transformer(
        torch.Generator(device=dev).manual_seed(seed), cfg)
    opt_init, _ = optimizers.make_optimizer(tc)
    return pod.init_pod_state(params, opt_init, fed.n_clients, fed,
                              torch.Generator(device=dev).manual_seed(
                                  seed + 1), mesh=mesh)


def _pod_cfgs(**fed_kw):
    from repro_torch.configs.base import FedConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    cfg = get_config(POD_ARCH)
    fed = FedConfig(n_clients=POD_C, **fed_kw)
    tc = TrainConfig(global_batch=POD_GB, seq_len=POD_SEQ, total_steps=10,
                     warmup_steps=1)
    return cfg, fed, tc


def _pod_mesh_parity(agg, comp, steps=2):
    """``agg_mesh`` set against None at world size 1, ``steps`` steps."""
    import torch
    from repro_torch.core import pod
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    cfg, fed, tc = _pod_cfgs(aggregator=agg, compress=comp)
    dev = torch.device(DEVICE)
    sample = train.synthetic_lm_batches(cfg, tc, POD_C, 0, dev)
    mesh = make_host_mesh()
    outs = []
    for m in (mesh, None):
        step = pod.make_train_step(cfg, fed, tc, robust="per_client",
                                   agg_mesh=m)
        st = _pod_state(cfg, fed, tc, dev, mesh=m)
        rows = []
        for t in range(steps):
            st, met = step(st, sample(t))
            rows.append({**{k: v.cpu().numpy() for k, v in met.items()},
                         "step": t})
        outs.append((st, rows))
    _same_state(f"[mesh] {agg}/{comp}", outs[0][0], outs[1][0])
    _same_rows(f"[mesh] {agg}/{comp}", outs[0][1], outs[1][1])
    print(f"[mesh] pod {agg}/{comp}: agg_mesh (NCCL, world size 1) bitwise "
          f"agg_mesh=None over {steps} steps")


def _pod_cpu_step(out):
    """Step 1 at full width and POD_CPU_LAYERS layers on the card and on
    the CPU port, from the same init and batch, compared on the aggregated
    grads: SGD's momentum after one step is the clipped aggregate itself
    (the params move by lr times it, ~1e-7, about an ulp of a param).
    Then the card's step once more with client C-1's rows replaced by
    client 0's: that aggregate must be outside the tolerance, or the check
    could not see a client dropped."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.core import pod
    from repro_torch.launch import train
    cfg, fed, tc = _pod_cfgs()
    cfg = cfg.replace(n_layers=POD_CPU_LAYERS)
    tc = dataclasses.replace(tc, optimizer="sgd")
    cpu = torch.device("cpu")
    batch = train.synthetic_lm_batches(cfg, tc, POD_C, 0, cpu)(0)
    st_cpu = _pod_state(cfg, fed, tc, cpu)
    to = lambda v: v.to(DEVICE) if isinstance(v, torch.Tensor) else v

    def on_card():
        st = tree.map(to, st_cpu)
        return st._replace(fed=st.fed._replace(
            rng=torch.Generator(device=DEVICE)))

    step = pod.make_train_step(cfg, fed, tc, robust="per_client")
    t0 = time.perf_counter()
    new_cpu, m_cpu = step(st_cpu, batch)
    cpu_s = time.perf_counter() - t0
    ref = tree.leaves(new_cpu.opt_state.momentum)
    scale = max(float(r.abs().max()) for r in ref)

    def rel_err(new):
        return max(float((a.cpu() - b).abs().max()) for a, b in zip(
            tree.leaves(new.opt_state.momentum), ref)) / scale

    new_gpu, m_gpu = step(on_card(), tree.map(to, batch))
    err = rel_err(new_gpu)
    if not (err <= POD_CPU_REL and torch.equal(new_gpu.fed.team.cpu(),
                                               new_cpu.fed.team)):
        raise AssertionError(f"[pod] step 1 on the card vs the CPU port: "
                             f"aggregated grads {err:.3e} of their largest")
    bc = POD_GB // POD_C
    swapped = {k: v.clone() if isinstance(v, torch.Tensor) else v
               for k, v in batch.items()}
    for k in ("tokens", "targets"):
        swapped[k][-bc:] = batch[k][:bc]
    fault = rel_err(step(on_card(), tree.map(to, swapped))[0])
    if not fault > POD_CPU_REL:
        raise AssertionError(f"[pod] a swapped client's step reads {fault:.3e}"
                             f", inside POD_CPU_REL")
    out["cpu_step_rel"], out["cpu_step_fault_rel"] = err, fault
    print(f"[pod] step 1 at full width, {POD_CPU_LAYERS} layers: card vs CPU "
          f"port aggregated grads {err:.3e} of their largest ({scale:.4g}; "
          f"tol {POD_CPU_REL}), same team; client {POD_C - 1}'s rows "
          f"swapped for client 0's: {fault:.3e}; loss "
          f"{float(m_gpu['loss']):.5f} / {float(m_cpu['loss']):.5f} (the "
          f"CPU step took {cpu_s:.1f} s)")


def _pod_kernels():
    """K1, K2 (three modes), K3, K6a, K6b and K6c at the pod path's shape
    (POD_SHAPE: tiny-lm's 64,233,984 parameters, C = 4) against their plain
    versions, and K3 / K6c against the fp64 Gram; CUDA-event times beside
    the bound and the library call.  The plain versions run once each
    (about a second a call at this N)."""
    import torch
    from repro_torch.comm.kernels import comm_codecs as cc
    from repro_torch.kernels import robust_pipeline as rp
    sizes = _pod_sizes()
    g, c, n = POD_SHAPE
    if sum(sizes) != n:
        raise AssertionError(f"tiny-lm has {sum(sizes)} parameters, not {n}")
    x, m, w = _inputs(POD_SHAPE, 22, [[1.0] * c])
    q, s, layout = _encode(x, sizes)
    calls = {
        "cosine_gate_partials": (lambda: rp.cosine_gate_partials(x, m),
                                 lambda: rp.cosine_gate_partials_plain(x, m),
                                 None),
        "gated_combine[mean]": (
            lambda: rp.gated_combine(x, m, w, mode="mean"),
            lambda: rp.gated_combine_plain(x, m, w, mode="mean"),
            lambda: torch.matmul(w[:, None, :], x)),
        "gated_combine[trimmed]": (
            lambda: rp.gated_combine(x, m, m, mode="trimmed"),
            lambda: rp.gated_combine_plain(x, m, m, mode="trimmed"), None),
        "gated_combine[median]": (
            lambda: rp.gated_combine(x, m, m, mode="median"),
            lambda: rp.gated_combine_plain(x, m, m, mode="median"),
            lambda: torch.quantile(x, 0.5, dim=1)),
        "pairwise_gram": (lambda: rp.pairwise_gram(x),
                          lambda: rp.pairwise_gram_plain(x),
                          lambda: torch.bmm(x, x.transpose(1, 2))),
        "dequant_gate_partials": (
            lambda: cc.dequant_gate_partials(q, s, layout, m),
            lambda: cc.dequant_gate_partials_plain(q, s, layout, m), None),
        "dequant_gated_combine[mean]": (
            lambda: cc.dequant_gated_combine(q, s, layout, m, w, mode="mean"),
            lambda: cc.dequant_gated_combine_plain(q, s, layout, m, w,
                                                   mode="mean"), None),
        "dequant_pairwise_gram": (
            lambda: cc.dequant_pairwise_gram(q, s, layout, m),
            lambda: cc.dequant_pairwise_gram_plain(q, s, layout, m), None),
    }
    gram_of = {"pairwise_gram": lambda: x,
               "dequant_pairwise_gram": lambda: cc.dequant_masked(q, s,
                                                                  layout, m)}
    entries = {}
    for name, (kern, plain, lib) in calls.items():
        base, _, mode = name.partition("[")
        out = kern()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        ref = plain()
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        if isinstance(out, tuple):
            err = max(_check(f"[pod] {name}/{i} {POD_SHAPE}", o, r,
                             rel=NSUM_REL) for i, (o, r) in
                      enumerate(zip(out, ref)))
        elif name in gram_of:
            err = _check(f"[pod] {name} {POD_SHAPE}", out, ref, rel=NSUM_REL)
            _gram_exact(f"[pod] {name}", out, ref, _gram64(gram_of[name]()))
        else:
            err = _check(f"[pod] {name} {POD_SHAPE}", out, ref,
                         exact=mode == "median]")
        del out, ref
        if lib and mode == "median]":
            _check(f"torch.quantile(0.5) as {name} {POD_SHAPE}", lib(),
                   kern(), rel=NSUM_REL)
        bound_ms, bound_by = bound(*kernel_work(
            base, g, c, n, mode.rstrip("]") or None, nq=layout.n_scales,
            n_leaves=len(sizes)))
        e = {"ms": time_ms(kern), "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": time_ms(lib) if lib else None,
             "max_abs_err": err, "shape": list(POD_SHAPE)}
        entries[name] = e
        print(f"[pod] {name} {POD_SHAPE}: {e['ms']:.4f} ms, plain "
              f"{plain_ms:.1f} ms, library {e['library_ms']}, bound "
              f"{bound_ms:.4f} ms ({bound_by}), max abs err {err:.3e}")
    return entries


def _gram64(x, chunk=1 << 26):
    """The fp64 Gram of a (G, C, N) buffer, summed in column chunks."""
    import torch
    gram = torch.zeros(x.shape[0], x.shape[1], x.shape[1],
                       dtype=torch.float64, device=x.device)
    for s in range(0, x.shape[-1], chunk):
        xc = x[..., s:s + chunk].double()
        gram += torch.bmm(xc, xc.transpose(1, 2))
    return gram


def _within_own_scale(name, parts, out, exact, ref=None):
    """``out`` against the fp64 ``exact``: each of ``parts`` ({label:
    selector}) within NSUM_REL of its own largest value (a Gram's
    off-diagonal entries are ~1e4 times smaller than its diagonal at these
    N, so a cross term summed wrong would hide under the whole matrix's
    scale); the plain version's ``ref`` is printed beside.  Returns the
    largest error as a share of its part's scale."""
    worst = 0.0
    for part, sel in parts.items():
        e = exact[sel]
        scale = float(e.abs().max())
        k_err = float((out.double()[sel] - e).abs().max())
        plain = ("" if ref is None else ", plain "
                 f"{float((ref.double()[sel] - e).abs().max()):.3e}")
        if not k_err <= NSUM_REL * scale:
            raise AssertionError(f"{name} {part}: {k_err:.3e} from the fp64 "
                                 f"reference (largest {scale:.4g})")
        print(f"{name} {part} against the fp64 reference (largest "
              f"{scale:.4g}): kernel {k_err:.3e}{plain} (tol "
              f"{NSUM_REL * scale:.3e})")
        worst = max(worst, k_err / scale)
    return worst


def _gram_exact(name, out, ref, exact):
    """A Gram against the fp64 Gram ``exact``: its diagonal and its
    off-diagonal entries each within NSUM_REL of their own largest."""
    import torch
    eye = torch.eye(exact.shape[-1], dtype=torch.bool, device=exact.device)
    return _within_own_scale(name, {"diagonal": (slice(None), eye),
                                    "off-diagonal": (slice(None), ~eye)},
                             out, exact, ref)


def _pod_sizes():
    """The pod model's leaf sizes, from the params ``init_transformer``
    draws."""
    import torch
    from repro_torch import tree
    from repro_torch.models import transformer
    params = transformer.init_transformer(
        torch.Generator(device=DEVICE).manual_seed(0), _pod_cfgs()[0])
    return [int(p.numel()) for p in tree.leaves(params)]


def _pod_int8_bytes():
    """The reference formula of the int8 uplink a step: C x (N codes + 4
    bytes x NQ scales), NQ = sum over leaves of ceil(n_l / 128), as the
    float32 metric holds it."""
    import numpy as np
    sizes = _pod_sizes()
    return float(np.float32(POD_C * (sum(sizes) + 4 * sum(
        -(-n // QBLK) for n in sizes))))


def _pod_step_timing(smi):
    """The pod step's wall under both drivers (``profile_round.measure``:
    the median of 10 steady steps, one host read each; scan: a chunk of 10
    replayed), one traced step's device busy time, idle share and launches
    from the host, and trained tokens/s."""
    import torch
    from repro_torch.core import pod
    from repro_torch.launch import profile_round as pr
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    cfg, fed, tc = _pod_cfgs()
    dev = torch.device(DEVICE)
    mesh = make_host_mesh()
    step = pod.make_train_step(cfg, fed, tc, robust="per_client",
                               agg_mesh=mesh)
    sample = train.synthetic_lm_batches(cfg, tc, POD_C, 0, dev)
    out = {}
    for drv in ("python", "scan"):
        m = pr.measure(lambda st, xs: step(st, xs[1]),
                       _pod_state(cfg, fed, tc, dev, mesh), sample,
                       driver=drv, device=dev)
        wall = m["chunk_round_ms"] if drv == "scan" else m["median_ms"]
        out[drv] = {"step_ms": m["median_ms"], "chunk_step_ms":
                    m.get("chunk_round_ms"), "busy_ms": m["busy_ms"],
                    "traced_ms": m["traced_ms"], "idle": m["idle"],
                    "host_launches": m["host_launches"],
                    "tokens_per_s": POD_GB * POD_SEQ / wall * 1e3}
        print(f"[timing] pod step driver={drv}: {m['median_ms']:.2f} ms "
              f"median of {len(m['walls'])} (one host read each)"
              + (f", {m['chunk_round_ms']:.2f} ms a step over a replayed "
                 f"chunk of {pr.ROUNDS}" if drv == "scan" else "")
              + f"; traced step busy {m['busy_ms']:.2f} of "
              f"{m['traced_ms']:.2f} ms (idle {m['idle']:.3f}), "
              f"{m['host_launches']} launches from the host; "
              f"{out[drv]['tokens_per_s']:.0f} tokens/s | {smi}")
    return out


def _pod_child():
    """``python3 chip_smoke.py --pod``: phase 9 alone, in a process whose
    cuBLAS workspace it fixes (CUBLAS_WORKSPACE_CONFIG, which must be set
    before cuBLAS starts: the earlier phases' process has long started
    it), so that deterministic algorithms can be switched on for the
    bitwise checks.  Prints its lines and then one JSON line ``{"pod":
    ...}`` for the parent."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_mod
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t0 = time.perf_counter()
    smi = _smi()
    _build.load()
    mesh_mod.start_group(DEVICE)
    out = {}
    try:
        out["launches"] = _pod_entry_point(out)
        torch.use_deterministic_algorithms(True)
        try:
            _pod_determinism(out)
        finally:
            torch.use_deterministic_algorithms(False)
        _pod_cpu_step(out)
        out["kernels"] = _pod_kernels()
        out["step"] = _pod_step_timing(smi)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    print(f"[pod] phase 9 took {out['seconds']:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    print(json.dumps({"pod": out}))
    return 0


def _pod(smi):
    """Phase 9: the pod trainer in a child process (``_pod_child``);
    returns its result dict."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--pod"], capture_output=True, text=True,
                          timeout=POD_TIMEOUT)
    lines = proc.stdout.splitlines()
    print("\n".join(l for l in lines if not l.startswith('{"pod"')))
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-20000:])
        raise RuntimeError(f"phase 9 failed (exit {proc.returncode})")
    return json.loads(next(l for l in reversed(lines)
                           if l.startswith('{"pod"')))["pod"]


# --------------------------------------------------------------- phase 10 --
def _gen(seed):
    import torch
    return torch.Generator(device=DEVICE).manual_seed(seed)


def _blk_reset():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import robust_pipeline as rp
    fa.reset_launch_counts()
    pd.reset_launch_counts()
    rp.reset_launch_counts()


def _blk_counts():
    """The launches of K1-K3, K8 and K9 since the last ``_blk_reset``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import robust_pipeline as rp
    return {k: n for k, n in {**rp.launch_counts(), **pd.launch_counts(),
                              **fa.launch_counts()}.items() if n}


def _blk_free():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _blk_params(cfg, seed=0, cast=True):
    """Random params of ``cfg`` drawn in fp32 on the card, cast once to the
    compute dtype (``transformer.cast_params``) unless ``cast`` is False."""
    from repro_torch.models import transformer
    from repro_torch.models.model import build
    p = build(cfg).init(_gen(seed))
    return transformer.cast_params(p, cfg) if cast else p


def _blk_kernels():
    """K8 at the GQA groups of granite (g = 2), dbrx (6) and musicgen (1),
    and K9 at the head shapes and lengths of the forwards phase 10 runs:
    hymba's sliding-window band (g = 5, dh 64, window 1,024), dbrx's (g =
    6, dh 128), llama-3.2-vision's (g = 8, dh 128) and musicgen's (g = 1,
    dh 64), in fp32 and bf16: each against its plain version on the card,
    then timed beside its bound and (K9) SDPA.  Returns {kernel: {arch:
    entry}}."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels.flash_attention_ref import band_mask
    out = {"paged_flash_decode": {}, "flash_attention_fwd": {}}
    for arch, (hq, hkv, dh) in K8_BLOCKS.items():
        cfg = get_config(arch)
        if (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim) != (hq, hkv,
                                                                     dh):
            raise AssertionError(f"{arch}: heads are not {hq}/{hkv}/{dh}")
        q, kp, vp, table, lengths = _paged_inputs(
            hq + dh, SERVE_SLOTS, SERVE_MAXP, SERVE_PAGE, hq, hkv, dh)
        kern = lambda: pd.paged_flash_decode(q, kp, vp, table, lengths)
        plain = lambda: pd.paged_flash_decode_plain(q, kp, vp, table, lengths)
        res = kern()
        err = _atol(f"paged_flash_decode {arch} g={hq // hkv}", res, plain(),
                    K8_ATOL)
        if float(res[3].abs().max()) != 0.0 or not torch.equal(res, kern()):
            raise AssertionError(f"K8 {arch}: inactive slot not 0 or two "
                                 "calls differ")
        shape = {"S": SERVE_SLOTS, "Hq": hq, "Hkv": hkv, "dh": dh,
                 "g": hq // hkv, "page": SERVE_PAGE, "maxp": SERVE_MAXP,
                 "keys": int(lengths.sum())}
        e = _attn_entry("paged_flash_decode", K8_SOURCE, K8_REPLACES, err,
                        kern, plain, None,
                        paged_work(lengths, SERVE_PAGE, SERVE_MAXP, hq, hkv,
                                   dh, 4, 2), shape)
        e["device_ms"] = device_ms(kern)
        out["paged_flash_decode"][arch] = e
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for arch, seq in K9_BLOCKS.items():
        cfg = get_config(arch)
        hq, hkv, dh, w = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                          cfg.sliding_window)
        qkv = [torch.randn(1, h, seq, dh, generator=_gen(7), device=DEVICE)
               for h in (hq, hkv, hkv)]
        err = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            x = [t.to(dtype) for t in qkv]
            res = fa.flash_attention_fwd(*x, causal=True, window=w)
            ref = fa.flash_attention_fwd_plain(*x, causal=True, window=w)
            label = f"flash_attention_fwd {arch} {dtype} g={hq // hkv} w={w}"
            err = max(err, _bf16_close(label, res, ref)
                      if dtype == torch.bfloat16
                      else _atol(label, res, ref, K9_ATOL))
            del res, ref
        x = [t.bfloat16() for t in qkv]
        band = band_mask(seq, True, w, DEVICE)
        kern = lambda: fa.flash_attention_fwd(*x, causal=True, window=w)
        e = _attn_entry(
            "flash_attention_fwd", K9_SOURCE, K9_REPLACES, err, kern,
            lambda: fa.flash_attention_fwd_plain(*x, causal=True, window=w),
            lambda: sdpa(*x, attn_mask=band, enable_gqa=True),
            flash_work(1, hq, hkv, seq, dh, w, 2),
            {"B": 1, "Hq": hq, "Hkv": hkv, "g": hq // hkv, "S": seq,
             "dh": dh, "dtype": "bfloat16", "window": w}, BF16_OPS_PER_S)
        e["device_ms"] = device_ms(kern)
        out["flash_attention_fwd"][arch] = e
    print("[blocks] K8 at g = 2 / 6 / 1 and K9 at g = 5 (window 1,024), 6, "
          "8 and 1, fp32 and bf16, agree with their plain versions")
    return out


def _blk_serve(cfg, params, n_req, gen, out, smi, full=False):
    """Paged serving of ``cfg`` behind ``ServeEngine`` (16 slots, pages of
    16, prompts of 128, K8): every request its tokens, every page back, K8
    once a layer and decode step, the first decode-step logits of 8
    requests within SERVE_LOGIT_REL of the ``attn="ref"`` engine's.
    ``full``: also the run with both steps eager (the same tokens) and the
    replayed decode step bitwise ``_decode`` run eagerly (``_serve_parity``
    at T = 0 and 0.7).  Returns K8's launches."""
    import torch
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.launch.serve import draw_requests
    from repro_torch.serve import ServeConfig, ServeEngine
    scfg = ServeConfig(**SERVE_CFG, attn="pallas")
    engine = ServeEngine(cfg, scfg, params)
    engine.run(draw_requests(1, SERVE_PROMPT, 2, 2, cfg.vocab_size, seed=9))
    reqs = draw_requests(n_req, SERVE_PROMPT, *gen, cfg.vocab_size, seed=0)
    pd.reset_launch_counts()
    results, stats = engine.run(reqs)
    k8 = pd.launch_counts()["paged_flash_decode"]
    _complete(f"{cfg.name} continuous", results, stats, reqs, scfg)
    if k8 != cfg.n_layers * stats["steps"]:
        raise AssertionError(f"{cfg.name}: K8 launched {k8} times in "
                             f"{stats['steps']} decode steps")
    med, lo, hi = _step_ms(stats)
    out["serve"] = {"requests": n_req, "tokens": stats["tokens"],
                    "steps": stats["steps"], "step_ms": med,
                    "tokens_per_s": stats["tokens_per_s"], "k8": k8}
    _serve_line(f"{cfg.name}, {n_req} requests, K8 x{k8} ({cfg.n_layers} a "
                "step), decode step and admission replayed", stats, smi)
    ref_engine = ServeEngine(cfg, ServeConfig(**SERVE_CFG, attn="ref"),
                             params)
    first, v = reqs[:8], cfg.vocab_size       # not the padded columns
    out["serve"]["first_step_err"] = _logits_close(
        f"serve {cfg.name} K8 vs ref",
        _first_step_logits(engine, first)[:, :v],
        _first_step_logits(ref_engine, first)[:, :v], SERVE_LOGIT_REL)
    del ref_engine
    if full:
        eager = _eager_admission_engine(cfg, scfg, params, eager_decode=True)
        eager.run(draw_requests(1, SERVE_PROMPT, 2, 2, cfg.vocab_size,
                                seed=9))
        e_results, e_stats = eager.run(reqs)
        del eager
        if e_results != results:
            raise AssertionError(f"{cfg.name}: the eager steps emitted other "
                                 "tokens than the replayed ones")
        out["serve"]["eager_step_ms"] = _step_ms(e_stats)[0]
        out["serve"]["eager_tokens_per_s"] = e_stats["tokens_per_s"]
        _serve_line(f"{cfg.name}, {n_req} requests, _decode and _admit "
                    "eagerly (the same tokens)", e_stats, smi)
        _serve_parity(engine, cfg, params, reqs[:SERVE_SLOTS])
    del engine
    _blk_free()
    return k8


def _blk_train(*extra):
    from repro_torch.launch import train
    return train.main(["--arch", GRANITE, "--clients", str(POD_C),
                       "--global-batch", str(POD_GB), "--seq", str(POD_SEQ),
                       "--robust", "per_client", "--device", DEVICE,
                       *extra])


def _host_state(state):
    import torch
    from repro_torch import tree
    return tree.map(lambda v: v.cpu() if isinstance(v, torch.Tensor) else v,
                    state)


def _blk_granite_train(out, smi):
    """granite-moe-1b-a400m trained by ``launch/train.py`` at full width and
    depth (C = 4, 16 x 256 tokens a step, AdamW, NCCL at world size 1):
    GRANITE_SCHEDULE, each step launching K1 and its K2 mode once (and K3
    under krum); the fedavg loss must fall.  Then, under deterministic
    algorithms, scan bitwise python (GRANITE_PARITY).  Returns {path:
    launches} of the schedule's runs."""
    import torch
    paths = {}
    for agg, steps in GRANITE_SCHEDULE:
        _blk_reset()
        t0 = time.perf_counter()
        st, rows = _blk_train("--steps", str(steps), "--aggregator", agg,
                              "--chunk-rounds", str(GRANITE_CHUNK))
        secs = time.perf_counter() - t0
        got = paths[f"{GRANITE} trained ({agg})"] = _blk_counts()
        if agg == "fedavg":         # the replayed step, from this state
            _blk_granite_trace(out, smi, st)
        del st
        _blk_free()
        want = ["cosine_gate_partials",
                {"trimmed_mean": "gated_combine[trimmed]"}.get(
                    agg, "gated_combine[mean]")]
        if agg == "krum":
            want.append("pairwise_gram")
        for k in want:
            if got.get(k) != steps:
                raise AssertionError(f"[blocks] granite {agg}: {k} launched "
                                     f"{got.get(k, 0)} times in {steps} "
                                     "steps")
        losses = [float(r["loss"]) for r in rows]
        print(f"[blocks] granite train.main --aggregator {agg}: {steps} steps "
              f"in {secs:.1f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"aux in it; launches {got}")
        if agg == "fedavg":
            if not losses[-1] < losses[0]:
                raise AssertionError(f"[blocks] granite: the loss did not "
                                     f"fall: {losses}")
            out["loss"] = [losses[0], losses[-1]]
    # the per-step loop at the default algorithms: its step's wall
    st, rows = _blk_train("--steps", str(GRANITE_PARITY[0]), "--driver",
                          "python")
    del st
    _blk_free()
    eager = sorted(float(r["wall_ms"]) for r in rows[1:])
    out["eager_step_ms"] = eager[len(eager) // 2]
    out["eager_tokens_per_s"] = POD_GB * POD_SEQ / out["eager_step_ms"] * 1e3
    print(f"[timing] granite pod step, the per-step loop: "
          f"{out['eager_step_ms']:.2f} ms, {out['eager_tokens_per_s']:.0f} "
          f"trained tokens/s | {smi}")
    steps, chunk = GRANITE_PARITY
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for drv in ("python", "scan"):
            _blk_reset()
            st, rows = _blk_train("--steps", str(steps), "--chunk-rounds",
                                  str(chunk), "--driver", drv)
            runs[drv] = (_host_state(st), rows, _blk_counts())
            del st
            _blk_free()
    finally:
        torch.use_deterministic_algorithms(False)
    _same_state("[parity] granite scan vs python", runs["scan"][0],
                runs["python"][0])
    _same_rows("[parity] granite scan vs python", runs["scan"][1],
               runs["python"][1])
    if runs["scan"][2] != runs["python"][2]:
        raise AssertionError(f"[parity] granite launches differ: "
                             f"{runs['scan'][2]} / {runs['python'][2]}")
    print(f"[parity] granite pod {steps} steps, chunks of {chunk}, "
          f"deterministic algorithms: scan vs python bitwise (params, AdamW "
          f"state, fed state, every history key); launches "
          f"{runs['scan'][2]}")
    del runs
    _blk_free()
    return paths


def _blk_granite_trace(out, smi, state):
    """granite's replayed pod step timed and traced
    (``profile_round.measure`` under the scan driver), continuing from
    ``state``, the fedavg run's final state (no second state is built): the
    median of 10 steady steps (the replayed step's time and tokens/s), one
    traced step's device busy time, idle share, launches from the host and
    its largest kernels by device time.  Run after the fedavg run's
    counters are read (measure's replays launch K1 and K2 too)."""
    import torch
    from repro_torch.configs.base import FedConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import pod
    from repro_torch.launch import profile_round as pr
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config(GRANITE)
    fed = FedConfig(n_clients=POD_C)
    tc = TrainConfig(global_batch=POD_GB, seq_len=POD_SEQ, total_steps=30,
                     warmup_steps=1)
    dev = torch.device(DEVICE)
    mesh = make_host_mesh()
    step = pod.make_train_step(cfg, fed, tc, robust="per_client",
                               agg_mesh=mesh)
    m = pr.measure(lambda st, xs: step(st, xs[1]), state,
                   train.synthetic_lm_batches(cfg, tc, POD_C, 0, dev),
                   driver="scan", device=dev)
    top = sorted(m["by_kernel"].items(), key=lambda kv: -kv[1][0])[:8]
    out["replayed_step_ms"] = m["median_ms"]
    out["replayed_tokens_per_s"] = POD_GB * POD_SEQ / m["median_ms"] * 1e3
    out["trace"] = {"step_ms": m["median_ms"], "busy_ms": m["busy_ms"],
                    "traced_ms": m["traced_ms"], "idle": m["idle"],
                    "host_launches": m["host_launches"],
                    "top": [[n[:80], ms, c] for n, (ms, c) in top]}
    print(f"[timing] granite pod step replayed: {m['median_ms']:.2f} ms "
          f"median of {len(m['walls'])}, "
          f"{out['replayed_tokens_per_s']:.0f} trained tokens/s; traced "
          f"step busy "
          f"{m['busy_ms']:.2f} of {m['traced_ms']:.2f} ms (idle "
          f"{m['idle']:.3f}), {m['host_launches']} launches from the host "
          f"| {smi}")
    for name, (ms, c) in top:
        print(f"[timing]   {ms:9.3f} ms  x{c:<5} {name[:90]}")
    _blk_free()


def _blk_granite_cpu_step(out):
    """Step 1 of granite at full width and 2 layers (fp32, SGD, 16 x
    BLK_CPU_SEQ tokens) on the card and on the CPU port: the aggregated
    grads within POD_CPU_REL of their largest; a step with client C - 1's
    rows swapped for client 0's must miss them."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import FedConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import pod
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.optim import optimizers
    cfg = get_config(GRANITE).replace(n_layers=BLK_CPU_LAYERS,
                                      dtype="float32")
    fed = FedConfig(n_clients=POD_C)
    tc = TrainConfig(global_batch=POD_GB, seq_len=BLK_CPU_SEQ,
                     total_steps=10, warmup_steps=1, optimizer="sgd")
    cpu = torch.device("cpu")
    batch = train.synthetic_lm_batches(cfg, tc, POD_C, 0, cpu)(0)
    params = tree.map(lambda t: t.cpu(),
                      transformer.init_transformer(_gen(0), cfg))
    opt_init, _ = optimizers.make_optimizer(tc)
    st_cpu = pod.init_pod_state(params, opt_init, POD_C, fed,
                                torch.Generator().manual_seed(1))
    to = lambda v: v.to(DEVICE) if isinstance(v, torch.Tensor) else v

    def on_card():
        st = tree.map(to, st_cpu)
        return st._replace(fed=st.fed._replace(
            rng=torch.Generator(device=DEVICE)))

    step = pod.make_train_step(cfg, fed, tc, robust="per_client")
    t0 = time.perf_counter()
    new_cpu, _ = step(st_cpu, batch)
    cpu_s = time.perf_counter() - t0
    ref = tree.leaves(new_cpu.opt_state.momentum)
    scale = max(float(r.abs().max()) for r in ref)

    def rel_err(new):
        return max(float((a.cpu() - b).abs().max()) for a, b in zip(
            tree.leaves(new.opt_state.momentum), ref)) / scale

    err = rel_err(step(on_card(), tree.map(to, batch))[0])
    bc = POD_GB // POD_C
    swapped = {k: v.clone() for k, v in batch.items()}
    for k in swapped:
        swapped[k][-bc:] = batch[k][:bc]
    fault = rel_err(step(on_card(), tree.map(to, swapped))[0])
    print(f"[blocks] granite step 1 at full width, {BLK_CPU_LAYERS} layers: "
          f"card vs CPU port aggregated grads {err:.3e} of their largest "
          f"({scale:.4g}; tol {POD_CPU_REL}); client {POD_C - 1}'s rows "
          f"swapped for client 0's: {fault:.3e} (the CPU step took "
          f"{cpu_s:.1f} s)")
    if not err <= POD_CPU_REL < fault:
        raise AssertionError("[blocks] granite step 1 vs the CPU port: "
                             f"{err:.3e}, swapped {fault:.3e}")
    out["cpu_step_rel"], out["cpu_step_fault_rel"] = err, fault


def _partials64(x, chunk=WHOLE_CHUNK):
    """K1's sums over N of an all-live (G, C, N) buffer in fp64, in column
    chunks: each row's dot with the coordinate median (the mean of the
    middle two of a sorted column at even C), its squared norm, and the
    median's squared norm."""
    import torch
    g, c, n = x.shape
    dots = torch.zeros(g, c, dtype=torch.float64, device=x.device)
    sqn = torch.zeros_like(dots)
    refsq = torch.zeros(g, 1, dtype=torch.float64, device=x.device)
    for s in range(0, n, chunk):
        xc = x[..., s:s + chunk].double()
        v = xc.sort(1).values
        med = 0.5 * (v[:, (c - 1) // 2] + v[:, c // 2])[:, None]
        dots += (xc * med).sum(-1)
        sqn += (xc * xc).sum(-1)
        refsq += (med * med).sum(-1)
    return dots, sqn, refsq


def _blk_big_kernels():
    """K1, K2 (three modes) and K3 on one (1, 4, 1,385,219,072) fp32 buffer,
    granite's per-client grads at C = 4 (22.2 GB; rows 2 and 3 start past
    2^32 elements).  First zeros but each row's last TAIL_COLS columns,
    random: the kernels on the whole buffer against their plain versions on
    those columns alone (the zeros add exact zeros; K2's other columns must
    be 0).  Then random on the whole: K2's three modes against their plain
    versions on the whole (in column steps of WHOLE_CHUNK: ``plain_ms``),
    K1's partial sums and K3's Gram against fp64 sums in column chunks
    (each part within NSUM_REL of its own largest; the plain versions'
    fp32 sums, also taken in steps of WHOLE_CHUNK, printed beside); each
    kernel timed beside its bound and library call.  Returns the
    entries."""
    import torch
    from repro_torch.kernels import robust_pipeline as rp
    g, c, n = GRANITE_SHAPE
    x = torch.zeros(GRANITE_SHAPE, device=DEVICE)
    x[..., -TAIL_COLS:] = torch.randn(g, c, TAIL_COLS, generator=_gen(5),
                                      device=DEVICE)
    m = torch.ones(g, c, device=DEVICE)
    w = torch.rand(g, c, generator=_gen(6), device=DEVICE) + 0.1
    w = w / w.sum(1, keepdim=True)
    tail = x[..., -TAIL_COLS:].contiguous()
    big = dict(chunk=WHOLE_CHUNK)
    calls = {
        "cosine_gate_partials": (
            lambda a: rp.cosine_gate_partials(a, m),
            lambda a, **k: rp.cosine_gate_partials_plain(a, m, **k), None),
        "gated_combine[mean]": (
            lambda a: rp.gated_combine(a, m, w, mode="mean"),
            lambda a, **k: rp.gated_combine_plain(a, m, w, mode="mean", **k),
            lambda a: torch.matmul(w[:, None, :], a)),
        "gated_combine[trimmed]": (
            lambda a: rp.gated_combine(a, m, m, mode="trimmed"),
            lambda a, **k: rp.gated_combine_plain(a, m, m, mode="trimmed",
                                                  **k), None),
        "gated_combine[median]": (
            lambda a: rp.gated_combine(a, m, m, mode="median"),
            lambda a, **k: rp.gated_combine_plain(a, m, m, mode="median",
                                                  **k), None),
        "pairwise_gram": (
            lambda a: rp.pairwise_gram(a),
            lambda a, **k: rp.pairwise_gram_plain(a, **k),
            lambda a: torch.bmm(a, a.transpose(1, 2))),
    }

    def timed(fn):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        res = fn()
        stop.record()
        torch.cuda.synchronize()
        return res, start.elapsed_time(stop)

    errs, tail_ms = {}, {}
    for name, (kern, plain, _) in calls.items():
        res = kern(x)
        ref, tail_ms[name] = timed(lambda: plain(tail))
        if isinstance(res, tuple):
            errs[name] = max(_check(f"[blocks] {name} tail/{i}", o, r,
                                    rel=NSUM_REL)
                             for i, (o, r) in enumerate(zip(res, ref)))
        elif name == "pairwise_gram":
            errs[name] = _check(f"[blocks] {name} tail", res, ref,
                                rel=NSUM_REL)
        else:
            if float(res[..., :-TAIL_COLS].abs().max()) != 0.0:
                raise AssertionError(f"[blocks] {name}: a zero column is "
                                     "not 0")
            errs[name] = _check(f"[blocks] {name} tail", res[..., -TAIL_COLS:],
                                ref, exact=name.endswith("median]"))
        del res, ref
    print(f"[blocks] K1, K2 (mean, trimmed, median) and K3 at {GRANITE_SHAPE}"
          f" ({g * c * n:,} elements; row 3 starts at element {3 * n:,}): "
          f"the last {TAIL_COLS} columns of every row against the plain "
          f"versions there, max abs err {errs}")
    del tail
    x.normal_(generator=_gen(8)).mul_(1e-2)
    exact = {"cosine_gate_partials": _partials64(x),
             "pairwise_gram": _gram64(x)}
    entries = {}
    for name, (kern, plain, lib) in calls.items():
        base, _, mode = name.partition("[")
        res = kern(x)
        ref, plain_ms = timed(lambda: plain(x, **big))
        label = f"[blocks] {name} whole"
        if name == "cosine_gate_partials":
            whole = max(_within_own_scale(label, {part: ...}, o, e, r)
                        for part, o, e, r in zip(("dots", "sqnorms", "refsq"),
                                                 res, exact[name], ref))
        elif name == "pairwise_gram":
            whole = _gram_exact(label, res, ref, exact[name])
        else:
            whole = _check(label, res, ref, exact=mode == "median]")
        del res, ref
        bound_ms, bound_by = bound(*kernel_work(base, g, c, n,
                                                mode.rstrip("]") or None))
        e = {"ms": time_ms(lambda: kern(x)), "plain_ms": plain_ms,
             "plain_chunk": WHOLE_CHUNK, "plain_tail_ms": tail_ms[name],
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": time_ms(lambda: lib(x)) if lib else None,
             "max_abs_err": (max(errs[name], whole)
                             if base == "gated_combine" else errs[name]),
             "whole_err": whole,
             "shape": list(GRANITE_SHAPE)}
        entries[name] = e
        print(f"[blocks] {name} {GRANITE_SHAPE}: {e['ms']:.3f} ms, plain "
              f"{plain_ms:.1f} ms (column steps of {WHOLE_CHUNK}), library "
              f"{e['library_ms']}, bound {bound_ms:.3f} ms ({bound_by}); "
              f"tail max abs err {errs[name]:.3e}, whole {whole:.3e} "
              + ("of the largest" if base != "gated_combine" else "abs"))
    del x, exact
    _blk_free()
    return entries


def _blk_decode_check(name, cfg, params, inputs, prompt, n_decode, ring,
                      out, smi, tol=None):
    """Prefill ``prompt`` inputs into the model's cache (ring: sliding-window
    rings), then ``n_decode`` decode steps fed the next inputs, each step's
    logits against the full forward's (plain attention) at that position.
    In fp32 every step within ``tol`` (by default DECODE_FP32_REL) of its
    own largest logit (a cache or recurrent state carried wrong from step 2
    on shows there); in bf16 the first within SERVE_LOGIT_REL, the later
    steps' drift printed.  Every step's logits finite."""
    import torch
    from repro_torch.models.model import build
    from repro_torch.models.transformer import DTYPES
    model = build(cfg.replace(attn_impl="xla"))
    total, v = prompt + n_decode, cfg.vocab_size
    full = model.forward(params, inputs)[:, prompt:total, :v].float()
    cache = model.init_cache(1, total + 1, ring=ring,
                             dtype=DTYPES[cfg.dtype], device=DEVICE)
    head = {k: (v if k == "image_embeds" else v[:, :prompt])
            for k, v in inputs.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = model.prefill(params, head, cache)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    rels, walls = [], []
    for i in range(n_decode):
        nxt = {k: v[:, prompt + i:prompt + i + 1] for k, v in inputs.items()
               if k != "image_embeds"}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode(params, nxt, cache, prompt + i)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        step = logits[:, 0, :v].float()
        if not bool(torch.isfinite(step).all()):
            raise AssertionError(f"[blocks] {name}: decode step {i + 1}'s "
                                 "logits are not finite")
        rels.append(float((step - full[:, i]).abs().max())
                    / float(full[:, i].abs().max()))
    fp32 = cfg.dtype == "float32"
    tol = tol or (DECODE_FP32_REL if fp32 else SERVE_LOGIT_REL)
    held = rels if fp32 else rels[:1]
    bad = [(i + 1, r) for i, r in enumerate(held) if not r <= tol]
    walls.sort()
    out["decode"] = {"prompt": prompt, "steps": n_decode, "ring": ring,
                     "first_step_rel": rels[0], "worst_step_rel": max(rels),
                     "held": "every step" if fp32 else "the first step",
                     "prefill_ms": prefill_ms,
                     "decode_ms": walls[len(walls) // 2]}
    print(f"[blocks] {name} {cfg.dtype}: prefill {prompt} in "
          f"{prefill_ms:.1f} ms, {n_decode} decode steps "
          f"({'ring' if ring else 'full'} cache), step ms median "
          f"{walls[len(walls) // 2]:.2f}; against the full forward, as a "
          f"share of each step's largest logit: step 1 {rels[0]:.3e}, the "
          f"worst {max(rels):.3e} (tol {tol}, held on "
          f"{out['decode']['held']}) | {smi}")
    if bad:
        raise AssertionError(f"[blocks] {name}: decode steps beyond {tol} "
                             f"of the full forward: {bad[:4]}")


def _blk_forward(name, cfg, params, inputs, out, smi, k9=0,
                 rel=FWD_HIDDEN_REL):
    """``Model.forward`` at full width with ``attn_impl="pallas"`` (K9 in
    each attention layer where S >= 128), timed on its second call: ``k9``
    launches, finite logits, and the last hidden state within ``rel`` of
    the plain attention's largest (None: printed, not held; a bf16 MoE
    forward routes a near-tied token elsewhere when the attention rounds
    differently, and that token's row moves by its whole size)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.models.model import build
    cfg = cfg.replace(attn_impl="pallas")
    build(cfg).forward(params, inputs)         # warm-up: cuBLAS's plans
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = build(cfg).forward(params, inputs)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    got = fa.launch_counts()["flash_attention_fwd"]
    if got != k9 or not bool(torch.isfinite(
            logits[..., :cfg.vocab_size]).all()):
        raise AssertionError(f"[blocks] {name}: K9 launched {got} times "
                             f"(want {k9}) or the logits are not finite")
    del logits
    kw = dict(tokens=inputs.get("tokens"), embeds=inputs.get("embeds"),
              image_embeds=inputs.get("image_embeds"), collect_logits=False)
    hid = {impl: transformer.forward(params, cfg.replace(attn_impl=impl),
                                     **kw)[0].float()
           for impl in ("pallas", "xla")}
    scale = float(hid["xla"].abs().max())
    err = float((hid["pallas"] - hid["xla"]).abs().max()) / scale
    shape = tuple(next(iter(inputs.values())).shape[:2])
    print(f"[blocks] {name} Model.forward {shape} {cfg.dtype}, K9 x{got}: "
          f"{ms:.1f} ms; last hidden vs the plain attention {err:.5f} of "
          f"max |h| (tol {rel}) | {smi}")
    if rel is not None and not err <= rel:
        raise AssertionError(f"[blocks] {name}: forward vs plain {err}")
    out["forward"] = {"ms": ms, "k9": got, "hidden_rel": err}
    return got


def _blk_inputs(cfg, b, s, seed):
    """Random inputs of ``cfg``: tokens, or frame embeddings (bf16) for an
    embeddings-input model, and image embeddings for a VLM."""
    import torch
    g = _gen(seed)
    inp = {}
    if cfg.embed_inputs:
        inp["tokens"] = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                      device=DEVICE)
    else:
        inp["embeds"] = torch.randn(b, s, cfg.d_model, generator=g,
                                    device=DEVICE).bfloat16()
    if cfg.arch_type == "vlm":
        inp["image_embeds"] = torch.randn(b, cfg.n_image_tokens, cfg.d_model,
                                          generator=g,
                                          device=DEVICE).bfloat16()
    return inp


def _blk_cpu_forward(name, cfg, out, swap):
    """The model at full width and ``cfg``'s layers in fp32, (2,
    BLK_CPU_SEQ) inputs, on the card and on the CPU port from the same
    params (cross-attention gates opened to 0.5): logits within
    ROUND1_LOGIT_REL of the largest; ``swap`` (of the card's params or
    inputs) must miss them."""
    import torch
    from repro_torch import tree
    from repro_torch.models.model import build
    model = build(cfg)
    params = _blk_params(cfg, seed=11, cast=False)
    for block in params["layers"].values():
        if "gate" in block:
            block["gate"].fill_(0.5)
    inputs = {k: v.float() if v.is_floating_point() else v
              for k, v in _blk_inputs(cfg, 2, BLK_CPU_SEQ, 12).items()}
    v = cfg.vocab_size                      # not the padded columns
    card = model.forward(params, inputs)[..., :v].float().cpu()
    params_cpu = tree.map(lambda t: t.cpu(), params)
    cpu = model.forward(params_cpu, {k: t.cpu() for k, t in inputs.items()}
                        )[..., :v]
    del params_cpu
    p2, i2 = swap(params, inputs)
    fault = model.forward(p2, i2)[..., :v].float().cpu()
    del params, p2, i2
    _blk_free()
    scale = float(cpu.abs().max())
    err = float((card - cpu).abs().max()) / scale
    bad = float((fault - cpu).abs().max()) / scale
    print(f"[blocks] {name} at full width, {cfg.n_layers} layers "
          f"{cfg.layers}, fp32: card vs CPU port logits {err:.3e} of the "
          f"largest (tol {ROUND1_LOGIT_REL}); swapped {bad:.3e}")
    if not err <= ROUND1_LOGIT_REL < bad:
        raise AssertionError(f"[blocks] {name} vs the CPU port: {err:.3e}, "
                             f"swapped {bad:.3e}")
    out["cpu_rel"], out["cpu_fault_rel"] = err, bad


def _swap_rows(key):
    """A control: the two batch rows of input ``key`` exchanged."""
    def swap(params, inputs):
        return params, dict(inputs, **{key: inputs[key].flip(0)})
    return swap


def _swap_experts(params, inputs):
    """A control: experts 0 and 1 of layer 0 exchange their gate weights."""
    import copy
    p = copy.copy(params)
    layers = {k: dict(v) for k, v in params["layers"].items()}
    moe = dict(layers["b0"]["moe"])
    wg = moe["wg"].clone()
    wg[0, [0, 1]] = wg[0, [1, 0]]
    moe["wg"] = wg
    layers["b0"] = dict(layers["b0"], moe=moe)
    p["layers"] = layers
    return p, inputs


def _blk_fp32(cfg):
    """``cfg`` in fp32, its params drawn as ``_blk_params`` draws them (the
    same values before the cast), for the decode checks."""
    cfg32 = cfg.replace(dtype="float32")
    return cfg32, _blk_params(cfg32, cast=False)


def _fp32_inputs(inputs):
    return {k: v.float() if v.is_floating_point() else v
            for k, v in inputs.items()}


def _blk_models(smi, out):
    """Phase 10's models other than granite's training: granite served;
    hymba, xlstm, musicgen, dbrx (2 layers) and llama-3.2-vision (one cycle
    of 5 layers) forward, prefill and decode (fp32 every step held, bf16
    timed); dbrx and musicgen served; each against the CPU port at 2
    layers.  Returns {path: launches}: K8's in each served run and K9's in
    each bf16 forward, read right after the reset that precedes that run
    (the check runs around them left out)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    paths = {}

    def reset():
        torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def done(name, t0):
        out[name]["seconds"] = time.perf_counter() - t0
        out[name]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"[blocks] {name} took {out[name]['seconds']:.1f} s, peak "
              f"{out[name]['peak_gb']:.2f} GB | {smi}")
        _blk_free()

    def serve(name, cfg, params, *args, **kw):
        paths[f"{name} served"] = {"paged_flash_decode": _blk_serve(
            cfg, params, *args, out[name], smi, **kw)}

    def forward(name, cfg, params, inputs, k9, **kw):
        got = _blk_forward(name, cfg, params, inputs, out[name], smi, k9=k9,
                           **kw)
        if got:
            paths[f"{name} forward"] = {"flash_attention_fwd": got}

    def decode32(name, cfg, seq, prompt, n_decode, ring, tol=None):
        """The fp32 decode check; returns the params cast to ``cfg``'s
        dtype."""
        cfg32, p32 = _blk_fp32(cfg)
        out[name].setdefault("fp32", {})
        _blk_decode_check(name, cfg32, p32,
                          _fp32_inputs(_blk_inputs(cfg, 1, seq, 2)), prompt,
                          n_decode, ring, out[name]["fp32"], smi, tol)
        out[name]["params"] = sum(t.numel() for t in _leaves(p32))
        params = transformer.cast_params(p32, cfg)
        del p32
        _blk_free()
        return params

    # granite served at full width and depth
    t0 = reset()
    cfg = get_config(GRANITE)
    params = _blk_params(cfg)
    n = sum(t.numel() for t in _leaves(params))
    if n != GRANITE_PARAMS:
        raise AssertionError(f"granite has {n:,} parameters")
    out[GRANITE] = {"params": n}
    serve(GRANITE, cfg, params, GRANITE_REQS, GRANITE_GEN, full=True)
    del params
    done(GRANITE, t0)

    # hymba: K9's band at g = 5, then the ring cache and the mamba state
    t0 = reset()
    cfg = get_config(HYMBA)
    out[HYMBA] = {}
    seq = HYMBA_PREFILL + HYMBA_DECODE
    params = decode32(HYMBA, cfg, seq, HYMBA_PREFILL, HYMBA_DECODE, True)
    forward(HYMBA, cfg, params, _blk_inputs(cfg, 1, HYMBA_SEQ, 1),
            cfg.n_layers)
    _blk_decode_check(HYMBA, cfg, params, _blk_inputs(cfg, 1, seq, 2),
                      HYMBA_PREFILL, HYMBA_DECODE, True, out[HYMBA], smi)
    del params
    _blk_cpu_forward(HYMBA, cfg.replace(n_layers=BLK_CPU_LAYERS,
                                        dtype="float32"),
                     out[HYMBA], _swap_rows("tokens"))
    done(HYMBA, t0)

    # xlstm: mLSTM and sLSTM, no attention.  In fp32 every layer an mLSTM at
    # the published prompt (the chunked prefill carries state over 4
    # chunks), then the published 7:1 pattern at a short prompt held within
    # XL_SLSTM_REL: at its random init the sLSTM amplifies rounding step by
    # step, so a 1,024-token prompt's comparison reads O(1) (PERF.md)
    t0 = reset()
    cfg = get_config(XLSTM)
    out[XLSTM] = {"fp32_mlstm": {}}
    cfg32, p32 = _blk_fp32(cfg.replace(block_pattern=("mlstm",) *
                                       cfg.n_layers))
    _blk_decode_check(f"{XLSTM} (every layer mLSTM)", cfg32, p32,
                      _fp32_inputs(_blk_inputs(cfg, 1, XL_SEQ + XL_DECODE,
                                               2)), XL_SEQ, XL_DECODE, False,
                      out[XLSTM]["fp32_mlstm"], smi)
    del p32
    params = decode32(XLSTM, cfg, XL_SLSTM_PROMPT + XL_DECODE,
                      XL_SLSTM_PROMPT, XL_DECODE, False, XL_SLSTM_REL)
    forward(XLSTM, cfg, params, _blk_inputs(cfg, 1, XL_SEQ, 1), 0)
    _blk_decode_check(XLSTM, cfg, params,
                      _blk_inputs(cfg, 1, XL_SEQ + XL_DECODE, 2), XL_SEQ,
                      XL_DECODE, False, out[XLSTM], smi)
    del params
    _blk_cpu_forward(XLSTM, cfg.replace(
        n_layers=BLK_CPU_LAYERS, dtype="float32",
        block_pattern=("mlstm", "slstm")), out[XLSTM], _swap_rows("tokens"))
    done(XLSTM, t0)

    # musicgen: frame embeddings in; K9 at g = 1; served paged with a token
    # table in front (its decode reads back the tokens it samples)
    t0 = reset()
    cfg = get_config(MUSICGEN)
    out[MUSICGEN] = {}
    params = decode32(MUSICGEN, cfg, XL_SEQ + XL_DECODE, XL_SEQ, XL_DECODE,
                      False)
    forward(MUSICGEN, cfg, params, _blk_inputs(cfg, 1, XL_SEQ, 1),
            cfg.n_layers)
    _blk_decode_check(MUSICGEN, cfg, params,
                      _blk_inputs(cfg, 1, XL_SEQ + XL_DECODE, 2), XL_SEQ,
                      XL_DECODE, False, out[MUSICGEN], smi)
    params["embed"] = (torch.randn(cfg.padded_vocab, cfg.d_model,
                                   generator=_gen(3), device=DEVICE) *
                       0.02).bfloat16()
    serve(MUSICGEN, cfg.replace(embed_inputs=True), params, 6, (4, 12))
    del params
    _blk_cpu_forward(MUSICGEN, cfg.replace(n_layers=BLK_CPU_LAYERS,
                                           dtype="float32"),
                     out[MUSICGEN], _swap_rows("embeds"))
    done(MUSICGEN, t0)

    # dbrx, 2 layers.  The fp32 checks at no-drop capacity, as the JAX tests
    # hold MoE decode against the forward (a capacity drop, or a near-tied
    # route that rounding flips, moves a token's row by its whole size):
    # the CPU port, K9 against the plain attention, decode against the
    # forward.  Then in bf16: the forward's time and K9's launches (its
    # hidden state against the plain attention's printed, not held: a route
    # flips), and serving (K8 at g = 6)
    t0 = reset()
    cfg = get_config(DBRX).replace(n_layers=DBRX_LAYERS)
    exact = cfg.replace(capacity_factor=float(cfg.n_experts))
    out[DBRX] = {"fp32": {}}
    _blk_cpu_forward(DBRX, exact.replace(dtype="float32"), out[DBRX],
                     _swap_experts)
    exact32, p32 = _blk_fp32(exact)
    out[DBRX]["params"] = sum(t.numel() for t in _leaves(p32))
    _blk_forward(DBRX, exact32, p32,
                 _fp32_inputs(_blk_inputs(exact, 1, CUT_SEQ, 1)),
                 out[DBRX]["fp32"], smi, k9=cfg.n_layers,
                 rel=ROUND1_LOGIT_REL)
    _blk_decode_check(DBRX, exact32, p32,
                      _fp32_inputs(_blk_inputs(exact, 1, CUT_SEQ, 2)),
                      CUT_SEQ - CUT_DECODE, CUT_DECODE, False,
                      out[DBRX]["fp32"], smi)
    params = transformer.cast_params(p32, cfg)
    del p32
    _blk_free()
    forward(DBRX, cfg, params, _blk_inputs(cfg, 1, CUT_SEQ, 1),
            cfg.n_layers, rel=None)
    serve(DBRX, cfg, params, 6, (4, 12))
    del params
    done(DBRX, t0)

    # llama-3.2-vision, one cycle (4 attn + 1 xattn), the cross-attention
    # gate opened to 0.5 (init 0) so that the image path counts
    t0 = reset()
    cfg = get_config(VISION).replace(n_layers=VISION_LAYERS)
    out[VISION] = {}
    cfg32, p32 = _blk_fp32(cfg)
    p32["layers"][f"b{VISION_LAYERS - 1}"]["gate"].fill_(0.5)
    out[VISION]["fp32"] = {}
    _blk_decode_check(VISION, cfg32, p32,
                      _fp32_inputs(_blk_inputs(cfg, 1, CUT_SEQ, 2)),
                      CUT_SEQ - CUT_DECODE, CUT_DECODE, False,
                      out[VISION]["fp32"], smi)
    out[VISION]["params"] = sum(t.numel() for t in _leaves(p32))
    params = transformer.cast_params(p32, cfg)
    del p32
    _blk_free()
    forward(VISION, cfg, params, _blk_inputs(cfg, 1, CUT_SEQ, 1),
            VISION_LAYERS - 1)
    _blk_decode_check(VISION, cfg, params, _blk_inputs(cfg, 1, CUT_SEQ, 2),
                      CUT_SEQ - CUT_DECODE, CUT_DECODE, False, out[VISION],
                      smi)
    del params
    _blk_cpu_forward(VISION, cfg.replace(
        n_layers=2, dtype="float32", block_pattern=("attn", "xattn")),
        out[VISION], _swap_rows("image_embeds"))
    done(VISION, t0)
    return paths


def _blocks_child(part):
    """``python3 chip_smoke.py --blocks models|train``: one part of phase 10
    in a process of its own (a fresh CUDA context: the models' graphs and
    caches are gone before granite's 70 GB of training state), which fixes
    cuBLAS's workspace before cuBLAS starts (deterministic algorithms for
    granite's scan-vs-python check).  Prints its lines and then one JSON
    line ``{"blocks": ...}`` for the parent."""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_mod
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t0 = time.perf_counter()
    smi = _smi()
    _build.load()
    out = {"models": {}, "kernels": {}, "launches": {}}
    if part == "models":
        out["kernels"] = _blk_kernels()
        out["launches"] = _blk_models(smi, out["models"])
    else:
        mesh_mod.start_group(DEVICE)
        try:
            g = out["models"][GRANITE] = {"train": {}}
            out["launches"] = _blk_granite_train(g["train"], smi)
            _blk_granite_cpu_step(g["train"])
            g["train"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        finally:
            dist.destroy_process_group()
        out["kernels"]["pod"] = _blk_big_kernels()
    out["seconds"] = time.perf_counter() - t0
    print(f"[blocks] phase 10 ({part}) took {out['seconds']:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | {smi}")
    print(json.dumps({"blocks": out}))
    return 0


def _blocks(smi):
    """Phase 10: its two parts, each in a child process
    (``_blocks_child``); returns their results merged."""
    merged = {"models": {}, "kernels": {}, "launches": {}, "seconds": {}}
    import os
    for part in ("models", "train"):
        # granite's training state, (4, N) grads buffer and optimizer
        # temporaries fragment the default allocator's segments (70 GB of
        # the card); expandable segments map them as one range
        env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF=(
            "expandable_segments:True")) if part == "train" else None
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--blocks", part], capture_output=True,
                              text=True, timeout=BLOCKS_TIMEOUT, env=env)
        lines = proc.stdout.splitlines()
        print("\n".join(l for l in lines if not l.startswith('{"blocks"')))
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-20000:])
            raise RuntimeError(f"phase 10 ({part}) failed (exit "
                               f"{proc.returncode})")
        res = json.loads(next(l for l in reversed(lines)
                              if l.startswith('{"blocks"')))["blocks"]
        for name, m in res["models"].items():
            merged["models"].setdefault(name, {}).update(m)
        merged["kernels"].update(res["kernels"])
        merged["launches"].update(res["launches"])
        merged["seconds"][part] = res["seconds"]
    return merged


# --------------------------------------------------------------- phase 11 --
def _tp_cfgs(arch=POD_ARCH, **fed_kw):
    from repro_torch.configs.base import FedConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    return (get_config(arch), FedConfig(n_clients=POD_C, **fed_kw),
            TrainConfig(global_batch=POD_GB, seq_len=POD_SEQ,
                        total_steps=10, warmup_steps=1))


def _tp_layout(mesh, name):
    """A ``NamedSharding`` tree maker over a whole state (or a params
    tree) by the ``sharding/specs.py`` function ``name``."""
    from repro_torch.sharding import specs
    fn = getattr(specs, name)
    return lambda t: specs.named(mesh, fn(t, mesh=mesh))


def _tp_state(cfg, fed, tc, mesh, layout=None, agg=False):
    """A fresh pod state from seed 0, placed by ``layout`` (a specs
    function's name) or plain."""
    import torch
    from repro_torch.core import pod
    from repro_torch.models import transformer
    from repro_torch.optim import optimizers
    opt_init, _ = optimizers.make_optimizer(tc)
    return pod.init_pod_state(
        transformer.init_transformer(_gen(0), cfg), opt_init, POD_C, fed,
        torch.Generator(device=DEVICE).manual_seed(1),
        mesh=mesh if agg else None,
        shardings=_tp_layout(mesh, layout) if layout else None)


def _tp_batch(cfg, tc, step_i=0):
    import torch
    from repro_torch.launch import train
    return train.synthetic_lm_batches(cfg, tc, POD_C, 0,
                                      torch.device(DEVICE))(step_i)


def _tp_params_host(state):
    from repro_torch import tree
    from repro_torch.sharding import dtensor
    return [x.detach().float() for x in tree.leaves(
        dtensor.whole(state.params))]


def _tp_hold(label, placed, plain, init):
    """Step-1 params of the placed path against the plain one: within
    TP_REL of the largest param change; returns (max abs diff, largest
    change, bitwise)."""
    diff = max(float((a - b).abs().max()) for a, b in zip(placed, plain))
    change = max(float((b - c).abs().max()) for b, c in zip(plain, init))
    bitwise = all(bool((a == b).all()) for a, b in zip(placed, plain))
    print(f"[tp] {label}: step-1 params max |placed - plain| {diff:.3e}, "
          f"largest param change {change:.3e}, bitwise {bitwise}")
    if not diff <= TP_REL * change:
        raise AssertionError(f"[tp] {label}: step-1 params differ by "
                             f"{diff:.3e} > {TP_REL} x {change:.3e}")
    return {"max_abs_diff": diff, "largest_change": change,
            "bitwise": bitwise}


def _tp_step1(*args, **kw):
    """``_tp_step1_run`` under deterministic algorithms: the MoE gathers'
    backward adds with atomics otherwise, so two runs of one step differ
    in the last bits."""
    import torch
    torch.use_deterministic_algorithms(True)
    try:
        return _tp_step1_run(*args, **kw)
    finally:
        torch.use_deterministic_algorithms(False)


def _tp_step1_run(label, cfg, fed, tc, mesh, robust, layout, zero1=None):
    """Step 1 on a state placed by ``layout`` against the same step on
    plain tensors (``zero1``: the ZeRO-1 step, held to the fp32 step's
    loss instead).  Returns its record."""
    from repro_torch.core import pod
    batch = _tp_batch(cfg, tc)
    st = _tp_state(cfg, fed, tc, mesh, agg=bool(robust))
    init = _tp_params_host(st)
    step = pod.make_train_step(cfg, fed, tc, robust=robust,
                               agg_mesh=mesh if robust else None)
    st, m_plain = step(st, batch)
    plain = _tp_params_host(st)
    del st, step
    _blk_free()
    st = _tp_state(cfg, fed, tc, mesh, layout, agg=bool(robust))
    kw = {}
    if zero1 is not None:
        kw["zero1_shardings"] = tuple(_tp_layout(mesh, f)(st.params)
                                      for f in zero1)
    step = pod.make_train_step(cfg, fed, tc, robust=robust,
                               agg_mesh=mesh if robust else None, **kw)
    _blk_reset()
    st, m = step(st, batch)
    rec = {"launches": _blk_counts(),
           "loss": float(m["loss"]), "plain_loss": float(m_plain["loss"]),
           "grad_norm": float(m["grad_norm"]),
           "plain_grad_norm": float(m_plain["grad_norm"])}
    if zero1 is None:
        rec.update(_tp_hold(label, _tp_params_host(st), plain, init))
    else:
        gap = abs(rec["loss"] - rec["plain_loss"])
        gn_gap = abs(rec["grad_norm"] / rec["plain_grad_norm"] - 1)
        print(f"[tp] {label}: step-1 loss {rec['loss']:.5f} against the "
              f"fp32 step's {rec['plain_loss']:.5f} (|d| {gap:.2e}), "
              f"grad_norm {rec['grad_norm']:.4f} against "
              f"{rec['plain_grad_norm']:.4f} (rel {gn_gap:.2e})")
        if not (gap < ZERO1_LOSS_ATOL and gn_gap < ZERO1_GN_REL):
            raise AssertionError(f"[tp] {label}: loss gap {gap} or grad_norm "
                                 f"{rec['grad_norm']} against "
                                 f"{rec['plain_grad_norm']}")
    del st, step, plain, init
    _blk_free()
    return rec


def _tp_run(cfg, fed, tc, mesh, layout, steps, driver, chunk=2,
            zero1=None):
    """``steps`` placed steps through ``pod.run`` -> (whole state, rows)."""
    from repro_torch.core import pod
    from repro_torch.launch import inputs, train
    from repro_torch.sharding import dtensor
    import torch
    st = _tp_state(cfg, fed, tc, mesh, layout)
    kw = {}
    if zero1 is not None:
        kw["zero1_shardings"] = tuple(_tp_layout(mesh, f)(st.params)
                                      for f in zero1)
    step = pod.make_train_step(cfg, fed, tc, **kw)
    sampler = train.synthetic_lm_batches(cfg, tc, POD_C, 0,
                                         torch.device(DEVICE))
    st, rows = pod.run(st, step, sampler, steps, driver=driver,
                       chunk_rounds=chunk,
                       batch_sharding=inputs.batch_shardings(sampler.specs,
                                                             mesh))
    return _host_state(dtensor.whole(st)), rows


def _tp_timing(label, cfg, fed, tc, mesh, layout, smi, zero1=None):
    """The placed step's wall under both drivers
    (``profile_round.measure``: the median of 10 steady steps, one host
    read each; scan: also a chunk of 10 replayed), one traced step's busy
    time and idle share, trained tokens/s, and the peak."""
    import torch
    from repro_torch.core import pod
    from repro_torch.launch import inputs, train
    from repro_torch.launch import profile_round as pr
    out = {}
    sampler = train.synthetic_lm_batches(cfg, tc, POD_C, 0,
                                         torch.device(DEVICE))
    bsh = inputs.batch_shardings(sampler.specs, mesh)

    def local(t):
        return {k: bsh[k].local(v) for k, v in sampler(t).items()}

    for drv in ("python", "scan"):
        torch.cuda.reset_peak_memory_stats()
        st = _tp_state(cfg, fed, tc, mesh, layout)
        kw = {}
        if zero1 is not None:
            kw["zero1_shardings"] = tuple(_tp_layout(mesh, f)(st.params)
                                          for f in zero1)
        step = pod.make_train_step(cfg, fed, tc, **kw)
        m = pr.measure(lambda s, xs: step(s, xs[1]), st, local, driver=drv,
                       device=torch.device(DEVICE))
        wall = m["chunk_round_ms"] if drv == "scan" else m["median_ms"]
        out[drv] = {"step_ms": m["median_ms"],
                    "chunk_step_ms": m.get("chunk_round_ms"),
                    "busy_ms": m["busy_ms"], "traced_ms": m["traced_ms"],
                    "idle": m["idle"], "host_launches": m["host_launches"],
                    "tokens_per_s": POD_GB * POD_SEQ / wall * 1e3,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"[timing] {label} driver={drv}: {m['median_ms']:.2f} ms "
              f"median of {len(m['walls'])} (one host read each)"
              + (f", {m['chunk_round_ms']:.2f} ms a step over a replayed "
                 f"chunk of {pr.ROUNDS}" if drv == "scan" else "")
              + f"; traced step busy {m['busy_ms']:.2f} of "
              f"{m['traced_ms']:.2f} ms (idle {m['idle']:.3f}), "
              f"{m['host_launches']} launches from the host; "
              f"{out[drv]['tokens_per_s']:.0f} tokens/s, peak "
              f"{out[drv]['peak_gb']:.2f} GB | {smi}")
        del st, step, m
        _blk_free()
    return out


def _tp_parity(label, cfg, fed, tc, mesh, layout, zero1=None):
    """scan bitwise python on the placed step (deterministic
    algorithms)."""
    import torch
    steps, chunk = TP_PARITY
    torch.use_deterministic_algorithms(True)
    try:
        runs = {drv: _tp_run(cfg, fed, tc, mesh, layout, steps, drv, chunk,
                             zero1) for drv in ("python", "scan")}
    finally:
        torch.use_deterministic_algorithms(False)
    _same_state(f"[parity] {label} scan vs python", runs["scan"][0],
                runs["python"][0])
    _same_rows(f"[parity] {label} scan vs python", runs["scan"][1],
               runs["python"][1])
    print(f"[parity] {label}: {steps} placed steps, chunks of {chunk}, "
          f"deterministic algorithms: scan vs python bitwise (params, AdamW "
          f"state, fed state, every history key)")
    _blk_free()


def _tp_padded_heads(mesh, cfg):
    """tiny-lm's first attention layer (weights from seed 0, placed as
    ``param_specs`` places them: columns of wq / wk / wv and rows of wo on
    "model") on (POD_GB, POD_SEQ) rows split over "data", run in heads
    padded as an uneven split over TP_PAD_PIECES ranks pads them (a zero q
    head, each q head with its own copy of its kv head) against the same
    call in its own heads: the output and the grads of x and of every
    weight within TP_PAD_REL of their largest.  Returns its record."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models import attention
    from repro_torch.sharding import dtensor
    dm = mesh.device_mesh
    w = attention.init_attention(_gen(0), cfg)
    params = {k: DTensor.from_local(
        v, dm, [Replicate(), Shard(0 if k == "wo" else 1)],
        run_check=False).requires_grad_() for k, v in w.items()}
    x = DTensor.from_local(
        torch.randn(POD_GB, POD_SEQ, cfg.d_model, generator=_gen(1),
                    device=DEVICE), dm, [Shard(0), Replicate()],
        run_check=False).requires_grad_()
    pos = torch.arange(POD_SEQ, device=DEVICE)[None].expand(POD_GB, -1)
    hd = attention.heads(params, cfg, TP_PAD_PIECES)

    def run(h):
        with dtensor.mixing():
            out, _ = attention.attention_fwd(params, x, cfg, pos, hd=h)
            grads = torch.autograd.grad((out * out).sum(),
                                        [x, *params.values()])
        return [dtensor.plain(t).detach() for t in (out, *grads)]

    padded, own = run(hd), run(None)
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(padded, own))
    print(f"[tp] tiny-lm attention in {hd.hp} padded heads ({cfg.n_heads} "
          f"q / {cfg.n_kv_heads} kv as split over {TP_PAD_PIECES} ranks), "
          f"placed at mesh (1, 1): output and grads within {rel:.3e} of "
          f"their largest of the call in its own heads")
    if not rel <= TP_PAD_REL:
        raise AssertionError(f"[tp] padded heads differ by {rel:.3e} > "
                             f"{TP_PAD_REL}")
    _blk_free()
    return {"heads": hd.hp, "max_rel": rel}


def _tp_slot_combine(cfg):
    """The placed MoE's combine of each rank's slots, on the card at
    granite's width: routing drawn from seed 0's logits, fp32 expert rows,
    each of TP_SLOT_BLOCKS blocks of the (E, C) slots combined by
    ``moe._slot_combine`` (the weighted rows added into an (N, d) partial by
    ``index_put``'s sorted accumulation) and the blocks summed, against
    ``moe._combine`` on the whole buffer: output and the expert rows' grad
    within TP_SLOT_REL of their largest.  Returns its record."""
    import torch
    from repro_torch.models import moe
    N, K, E, d = POD_GB * POD_SEQ, cfg.top_k, cfg.n_experts, cfg.d_model
    C = moe._capacity(N, cfg)
    logits = torch.randn(N, E, generator=_gen(0), device=DEVICE)
    top_p, top_e = torch.topk(torch.softmax(logits, -1), K)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    eo = torch.randn(E, C, d, generator=_gen(1), device=DEVICE,
                     requires_grad=True)
    order, tok, _, start, _, keep, dest = moe._dispatch_parts(top_e, N, cfg)
    want = moe._combine(eo, top_p, order, keep, dest, N, cfg)
    (be, bc), got = TP_SLOT_BLOCKS, 0
    en, cn = E // be, C // bc
    for i in range(be):
        for j in range(bc):
            at, held, rows = moe._slot_map(start, tok, N, K, (i * en, en),
                                           (j * cn, cn))
            blk = eo[i * en:(i + 1) * en, j * cn:(j + 1) * cn]
            got = got + moe._slot_combine(
                blk.reshape(-1, d), top_p.reshape(-1)[order[at]], held,
                rows, N)
    cot = torch.randn(N, d, generator=_gen(2), device=DEVICE)
    grads = [torch.autograd.grad((o * cot).sum(), eo)[0] for o in (got,
                                                                   want)]
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in ((got.detach(), want.detach()), grads))
    print(f"[tp] granite MoE combine over {be} x {bc} blocks of its "
          f"({E}, {C}) slots, {N} tokens, d {d}: output and grad within "
          f"{rel:.3e} of their largest of the plain combine")
    if not rel <= TP_SLOT_REL:
        raise AssertionError(f"[tp] slot combine differs by {rel:.3e} > "
                             f"{TP_SLOT_REL}")
    _blk_free()
    return {"blocks": [be, bc], "max_rel": rel}


def _tp_tiny(smi, out):
    """Phase 11 on tiny-lm at full width; returns {path: launches}."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    paths = {}
    cfg, fed, tc = _tp_cfgs()
    out["padded_heads"] = _tp_padded_heads(mesh, cfg)
    out["baseline"] = _tp_step1("tiny-lm robust=None, param_specs", cfg,
                                fed, tc, mesh, None, "param_specs")
    for agg in ("fedavg", "trimmed_mean"):
        cfg, fed, tc = _tp_cfgs(aggregator=agg)
        rec = out[f"per_client_{agg}"] = _tp_step1(
            f"tiny-lm per_client {agg}, param_specs", cfg, fed, tc, mesh,
            "per_client", "param_specs")
        paths[f"tiny-lm placed per_client {agg}"] = rec["launches"]
        want = ["cosine_gate_partials",
                "gated_combine[trimmed]" if agg == "trimmed_mean"
                else "gated_combine[mean]"]
        for k in want:
            if rec["launches"].get(k) != 1:
                raise AssertionError(f"[tp] per_client {agg}: {k} launched "
                                     f"{rec['launches'].get(k, 0)} times "
                                     "in a step")
    cfg, fed, tc = _tp_cfgs()
    zero1 = ("param_specs_tp", "param_specs")
    out["zero1"] = _tp_step1("tiny-lm ZeRO-1 (param_specs_tp / "
                             "param_specs)", cfg, fed, tc, mesh, None,
                             "param_specs", zero1)
    _, rows = _tp_run(cfg, fed, tc, mesh, "param_specs", TP_STEPS,
                      "python", zero1=zero1)
    losses = [float(r["loss"]) for r in rows]
    if not (losses[-1] < losses[0] and all(
            math.isfinite(float(r["grad_norm"])) for r in rows)):
        raise AssertionError(f"[tp] ZeRO-1: the loss did not fall or a "
                             f"grad_norm is not finite: {rows}")
    out["zero1"]["losses"] = losses
    print(f"[tp] tiny-lm ZeRO-1: {TP_STEPS} steps, loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}")
    _tp_parity("tiny-lm param_specs", cfg, fed, tc, mesh, "param_specs")
    _tp_parity("tiny-lm ZeRO-1", cfg, fed, tc, mesh, "param_specs", zero1)
    out["timing"] = {
        "plain": _tp_timing("tiny-lm plain step (unplaced)", cfg, fed, tc,
                            mesh, None, smi),
        "param_specs": _tp_timing("tiny-lm placed step (param_specs)", cfg,
                                  fed, tc, mesh, "param_specs", smi),
        "zero1": _tp_timing("tiny-lm placed step (ZeRO-1)", cfg, fed, tc,
                            mesh, "param_specs", smi, zero1)}
    t = out["timing"]
    print("[timing] tiny-lm plain vs placed, one run: per-step loop "
          f"{t['plain']['python']['step_ms']:.2f} vs "
          f"{t['param_specs']['python']['step_ms']:.2f} ms, replayed "
          f"{t['plain']['scan']['chunk_step_ms']:.2f} vs "
          f"{t['param_specs']['scan']['chunk_step_ms']:.2f} ms | {smi}")
    return paths


def _tp_granite(smi, out):
    """Phase 11 on granite at full depth under the MoE layouts."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    cfg, fed, tc = _tp_cfgs(GRANITE)
    out["slot_combine"] = _tp_slot_combine(cfg)
    out["moe_ff"] = _tp_step1("granite robust=None, param_specs_moe_ff",
                              cfg, fed, tc, mesh, None,
                              "param_specs_moe_ff")
    out["zero1_moe"] = _tp_step1(
        "granite ZeRO-1 (param_specs_zero1_moe / param_specs_moe_ff)", cfg,
        fed, tc, mesh, None, "param_specs_moe_ff",
        ("param_specs_zero1_moe", "param_specs_moe_ff"))
    for name, zero1 in (("moe_ff", None), ("zero1_moe", (
            "param_specs_zero1_moe", "param_specs_moe_ff"))):
        torch.cuda.reset_peak_memory_stats()
        _, rows = _tp_run(cfg, fed, tc, mesh, "param_specs_moe_ff",
                          TP_GRANITE_STEPS, "python", zero1=zero1)
        walls = sorted(float(r["wall_ms"]) for r in rows[1:])
        rec = out[name]
        rec["step_ms"] = walls[len(walls) // 2]
        rec["tokens_per_s"] = POD_GB * POD_SEQ / rec["step_ms"] * 1e3
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["losses"] = [float(r["loss"]) for r in rows]
        print(f"[timing] granite placed step ({name}), the per-step loop: "
              f"{rec['step_ms']:.2f} ms, {rec['tokens_per_s']:.0f} tokens/s,"
              f" peak {rec['peak_gb']:.2f} GB, loss {rec['losses']} | {smi}")
        _blk_free()


def _tp_child():
    """``python3 chip_smoke.py --tp``: phase 11 alone, in a process that
    fixes cuBLAS's workspace before cuBLAS starts.  Prints its lines and
    then one JSON line ``{"tp": ...}`` for the parent."""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_mod
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t0 = time.perf_counter()
    smi = _smi()
    _build.load()
    mesh_mod.start_group(DEVICE)
    out = {"tiny": {}, "granite": {}}
    try:
        out["launches"] = _tp_tiny(smi, out["tiny"])
        _tp_granite(smi, out["granite"])
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    print(f"[tp] phase 11 took {out['seconds']:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | {smi}")
    print(json.dumps({"tp": out}))
    return 0


def _tp(smi):
    """Phase 11 in a child process (``_tp_child``); returns its result."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--tp"], capture_output=True, text=True,
                          timeout=TP_TIMEOUT)
    lines = proc.stdout.splitlines()
    print("\n".join(l for l in lines if not l.startswith('{"tp"')))
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-20000:])
        raise RuntimeError(f"phase 11 failed (exit {proc.returncode})")
    return json.loads(next(l for l in reversed(lines)
                           if l.startswith('{"tp"')))["tp"]


# --------------------------------------------------------------- phase 12 --
def _kernel_counts(reset=False):
    """Every kernel wrapper's launch counter, by the kernels line's names
    (``reset``: each set to 0 first)."""
    from repro_torch.comm.kernels import comm_codecs as cc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import population_select as ps
    from repro_torch.kernels import robust_agg as ra
    from repro_torch.kernels import robust_pipeline as rp
    if reset:
        for mod in (rp, cc, ra, ps, pd, fa):
            mod.reset_launch_counts()
    return {**_counts(), **ps.launch_counts(), **pd.launch_counts(),
            **fa.launch_counts()}


def _dryrun_fake_child():
    """``python3 chip_smoke.py --dryrun fake``: phase 12's dry-runs, on fake
    tensors over fake process groups (no card is used).  Prints one JSON
    line a run and then ``{"dryrun_fake": ...}`` for the parent."""
    import contextlib
    import io
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun, perf
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import roofline as roof
    t0 = time.perf_counter()
    _kernel_counts(reset=True)
    out = {"runs": {}, "anchors": {}}

    def keep(name, res, t):
        res["wall_s"] = time.perf_counter() - t
        out["runs"][name] = res
        print(f"[dryrun] {name}: {json.dumps(res, default=float)}",
              flush=True)

    t = time.perf_counter()
    keep("qwen2.5-14b x train_4k 16x16", dryrun.run_one(
        *DRYRUN_QWEN, verbose=False), t)
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = perf.measure(*DRYRUN_PERF)
    keep("perf dbrx zero1_moe 16x16", res, t)
    t = time.perf_counter()
    keep("minitron-4b x decode_32k tp_serve 16x16", dryrun.run_one(
        *DRYRUN_SERVE, variant="tp_serve", verbose=False), t)
    t = time.perf_counter()
    keep("minitron-4b x decode_32k 2x16x16", dryrun.run_one(
        *DRYRUN_SERVE, multi_pod=True, verbose=False), t)
    shape = InputShape("anchor", POD_SEQ, POD_GB, "train")
    for arch in DRYRUN_ANCHORS:
        t = time.perf_counter()
        with mesh_mod.fake_group(1):
            mesh = mesh_mod.make_grid_mesh((1, 1), ("data", "model"))
            low, _ = dryrun.lower_train(get_config(arch), shape, mesh,
                                        n_clients=POD_C)
        terms = roof.roofline(low.cost, low.collectives)
        out["anchors"][arch] = {"cost": low.cost,
                                "collectives": low.collectives,
                                "memory": low.memory,
                                "bound_s": terms["bound_s"],
                                "dominant": terms["dominant"],
                                "wall_s": time.perf_counter() - t}
        print(f"[dryrun] anchor {arch} at mesh (1, 1), counted on fake "
              f"tensors: {json.dumps(out['anchors'][arch], default=float)}",
              flush=True)
    out["launches"] = _kernel_counts()
    moved = {k: n for k, n in out["launches"].items() if n}
    if moved:
        raise AssertionError(f"[dryrun] the dry-run launched kernels: "
                             f"{moved}")
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"dryrun_fake": out}, default=float))
    return 0


def _anchor_step(arch, mesh, cfg=None, counted=True):
    """The anchor's step on the card: ``dryrun.train_setup`` (placed by
    ``param_specs`` at mesh (1, 1), C = 4, 16 x 256 tokens) on params drawn
    on the card, step 1 under the cost counter (``counted``).  Returns
    (its record, the state after it, the step, the batch)."""
    import contextlib
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as roof
    from repro_torch.models import transformer
    cfg = cfg or get_config(arch)
    state, batch, step = dryrun.train_setup(
        cfg, InputShape("anchor", POD_SEQ, POD_GB, "train"), mesh,
        transformer.init_transformer(_gen(0), cfg), n_clients=POD_C)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter = roof.CostCounter()
    if counted:
        counter.track(state, batch)
    t = time.perf_counter()
    with counter if counted else contextlib.nullcontext():
        state, m = step(state, batch)
    torch.cuda.synchronize()
    rec = {"step1_s": time.perf_counter() - t,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "loss": float(m["loss"])}
    if counted:
        cost, coll = counter.costs()
        rec.update(cost=cost, collectives=coll,
                   counter_peak_bytes=counter.peak_bytes)
    return rec, state, step, batch


def _replayed_ms(state, step, batch):
    """The step replayed under ``pod.run`` (ScanDriver: captured once):
    chunks of ANCHOR_CHUNK steps, the first (eager step and capture) left
    out; ms a step over the others."""
    from repro_torch.core import pod
    marks = []
    pod.run(state, step, lambda t: batch, ANCHOR_CHUNK * ANCHOR_CHUNKS,
            driver="scan", chunk_rounds=ANCHOR_CHUNK,
            on_chunk=lambda st, rows: marks.append(time.perf_counter()))
    return (marks[-1] - marks[0]) / (ANCHOR_CHUNK * (ANCHOR_CHUNKS - 1)) \
        * 1e3


def _dryrun_remat(mesh, out, smi):
    """granite's placed step with remat off then on, under deterministic
    algorithms: step 1 bitwise (params), step 1 counted (the anchor) with
    remat on, step 2 timed; peak of step 1 both ways."""
    import torch
    from repro_torch import tree
    from repro_torch.configs.registry import get_config
    from repro_torch.sharding import dtensor
    host = None
    torch.use_deterministic_algorithms(True)
    try:
        for remat in (False, True):
            cfg = get_config(GRANITE).replace(remat=remat)
            rec, state, step, batch = _anchor_step(GRANITE, mesh, cfg,
                                                   counted=remat)
            params = [x.detach() for x in tree.leaves(
                dtensor.whole(state.params))]
            if host is None:
                host = [x.cpu() for x in params]
            else:
                same = all(torch.equal(a.cpu(), b)
                           for a, b in zip(params, host))
                if not same:
                    raise AssertionError("[remat] granite step 1 differs "
                                         "with remat on")
                print("[remat] granite placed step 1 (param_specs, mesh "
                      "(1, 1), deterministic algorithms): remat on bitwise "
                      "remat off (every param)")
            del params
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            rec["step2_ms"] = (time.perf_counter() - t) * 1e3
            rec["peak_gb"] = rec["max_memory_allocated"] / 1e9
            print(f"[remat] granite remat={remat}: step 1 peak "
                  f"{rec['peak_gb']:.2f} GB, step 2 {rec['step2_ms']:.1f} "
                  f"ms (per-step loop) | {smi}")
            out[f"remat_{remat}"] = rec
            if remat:
                rec["replayed_ms"] = _replayed_ms(state, step, batch)
            del state, step, batch
            _blk_free()
    finally:
        torch.use_deterministic_algorithms(False)
    out[GRANITE] = out["remat_True"]


def _dryrun_tp_serve(mesh, out):
    """minitron-4b at full width and depth: prefill and decode on params
    placed by ``param_specs_tp`` and a cache placed by ``cache_specs``
    (mesh (1, 1)) against the same calls on plain tensors: logits
    bitwise."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.models.model import build
    from repro_torch.sharding import dtensor, specs
    cfg = get_config(DRYRUN_SERVE[0])
    model = build(cfg)
    params = transformer.cast_params(model.init(_gen(0)), cfg)
    toks = torch.randint(0, cfg.vocab_size,
                         (TP_SERVE_B, TP_SERVE_PROMPT + TP_SERVE_DECODE),
                         generator=_gen(1), device=DEVICE)
    max_len = TP_SERVE_PROMPT + TP_SERVE_DECODE

    def serve(placed):
        p = params
        cache = model.init_cache(TP_SERVE_B, max_len, device=DEVICE)
        batches = [{"tokens": toks[:, :TP_SERVE_PROMPT]}] + [
            {"tokens": toks[:, TP_SERVE_PROMPT + t:TP_SERVE_PROMPT + t + 1]}
            for t in range(TP_SERVE_DECODE)]
        if placed:
            p = dtensor.place(p, specs.named(mesh, specs.param_specs_tp(
                p, mesh=mesh)))
            cache = dtensor.place(cache, specs.named(
                mesh, specs.cache_specs(cache, mesh)))
            batches = [dtensor.place(b, specs.named(
                mesh, specs.batch_specs(b, mesh))) for b in batches]
        with torch.no_grad():
            lg, cache = model.prefill(p, batches[0], cache)
            out_ = [dtensor.plain(lg)]
            for t, b in enumerate(batches[1:]):
                lg, cache = model.decode(p, b, cache, TP_SERVE_PROMPT + t)
                out_.append(dtensor.plain(lg))
        return out_

    plain, placed = serve(False), serve(True)
    for i, (a, b) in enumerate(zip(placed, plain)):
        if not torch.equal(a, b):
            raise AssertionError(f"[tp_serve] minitron-4b call {i}: placed "
                                 "logits differ from the plain call's")
    out["tp_serve"] = {"calls": len(plain), "bitwise": True}
    print(f"[tp_serve] minitron-4b prefill ({TP_SERVE_B} x "
          f"{TP_SERVE_PROMPT}) + {TP_SERVE_DECODE} decode steps on "
          "param_specs_tp params and a cache_specs cache (mesh (1, 1)): "
          "logits bitwise the plain call's")
    del params
    _blk_free()


def _dryrun_card_child():
    """``python3 chip_smoke.py --dryrun card``: phase 12's steps on the card
    (the anchors under the cost counter, remat, tp_serve).  Prints its lines
    and then ``{"dryrun_card": ...}`` for the parent."""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t0 = time.perf_counter()
    smi = _smi()
    _kernel_counts(reset=True)
    mesh_mod.start_group(DEVICE)
    out = {}
    try:
        mesh = mesh_mod.make_host_mesh()
        rec, state, step, batch = _anchor_step(POD_ARCH, mesh)
        rec["replayed_ms"] = _replayed_ms(state, step, batch)
        out[POD_ARCH] = rec
        del state, step, batch
        _blk_free()
        _dryrun_remat(mesh, out, smi)
        cfg, fed, tc = _tp_cfgs()
        _tp_parity("tiny-lm remat=True, param_specs",
                   cfg.replace(remat=True), fed, tc, mesh, "param_specs")
        _dryrun_tp_serve(mesh, out)
    finally:
        dist.destroy_process_group()
    out["launches"] = _kernel_counts()
    moved = {k: n for k, n in out["launches"].items() if n}
    if moved:
        raise AssertionError(f"[dryrun] phase 12 launched kernels: {moved}")
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"dryrun_card": out}, default=float))
    return 0


def _dryrun_start():
    """Starts phase 12's fake-tensor child (it needs no card: it runs beside
    phase 11)."""
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--dryrun", "fake"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _child_json(lines, key):
    return json.loads(next(l for l in reversed(lines)
                           if l.startswith('{"' + key + '"')))[key]


def _dryrun_gates(runs, smi):
    """The fake child's counts of the sharded step against their limits
    (DRYRUN_XLA_QWEN_FLOPS, DRYRUN_SERVE_AG_MAX)."""
    qwen = runs["qwen2.5-14b x train_4k 16x16"]["hlo_flops"]
    ratio = qwen / DRYRUN_XLA_QWEN_FLOPS
    print(f"[dryrun] qwen2.5-14b x train_4k 16x16: {qwen:.4e} flops a chip, "
          f"{ratio:.3f}x XLA's count of the reference's step (limit "
          f"{DRYRUN_FLOPS_OVER_XLA}) | {smi}")
    if not ratio <= DRYRUN_FLOPS_OVER_XLA:
        raise AssertionError(f"[dryrun] qwen2.5-14b train_4k flops {ratio}x "
                             "XLA's")
    for name, limit in DRYRUN_SERVE_AG_MAX.items():
        ag = runs[name]["collective_by_kind"]["all-gather"]
        print(f"[dryrun] {name}: all-gather {ag / 1e9:.4f} GB a chip (limit "
              f"{limit / 1e9:.4f}: 1/8 of the step that gathered the "
              "cache)")
        if not ag <= limit:
            raise AssertionError(f"[dryrun] {name}: all-gather {ag} B > "
                                 f"{limit}")


def _dryrun(smi, fake):
    """Phase 12: the card child, then the fake child joined; the anchor's
    gates.  Returns the merged record, with ``launches``: both children's
    kernel launches summed by kernel name."""
    import os
    t0 = time.perf_counter()
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--dryrun", "card"], capture_output=True,
                          text=True, timeout=DRYRUN_TIMEOUT, env=env)
    lines = proc.stdout.splitlines()
    print("\n".join(l for l in lines if not l.startswith('{"dryrun_card"')))
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-20000:])
        raise RuntimeError(f"phase 12 (card) failed (exit {proc.returncode})")
    card = _child_json(lines, "dryrun_card")
    fake_out, fake_err = fake.communicate(timeout=DRYRUN_TIMEOUT)
    lines = fake_out.splitlines()
    print("\n".join(l for l in lines if not l.startswith('{"dryrun_fake"')))
    if fake.returncode != 0:
        sys.stderr.write(fake_err[-20000:])
        raise RuntimeError(f"phase 12 (fake) failed (exit {fake.returncode})")
    dry = _child_json(lines, "dryrun_fake")
    _dryrun_gates(dry["runs"], smi)
    for arch in DRYRUN_ANCHORS:
        real, fk = card[arch], dry["anchors"][arch]
        if real["cost"]["flops"] != fk["cost"]["flops"]:
            raise AssertionError(f"[anchor] {arch}: {real['cost']['flops']} "
                                 f"flops counted on the card, "
                                 f"{fk['cost']['flops']} in the dry-run")
        if any(real["collectives"].values()) or any(
                fk["collectives"].values()):
            raise AssertionError(f"[anchor] {arch}: collective bytes at "
                                 f"mesh (1, 1): {real['collectives']} / "
                                 f"{fk['collectives']}")
        peak, got = real["max_memory_allocated"], fk["memory"]["peak_bytes"]
        if abs(got - peak) > DRYRUN_PEAK_REL * peak:
            raise AssertionError(f"[anchor] {arch}: dry-run peak {got} B "
                                 f"against {peak} B on the card")
        frac = real["replayed_ms"] / 1e3 / fk["bound_s"]
        real["replayed_over_bound"] = frac
        print(f"[anchor] {arch} (C = {POD_C}, {POD_GB} x {POD_SEQ} tokens, "
              f"robust=None, mesh (1, 1)): {fk['cost']['flops']:.6e} flops "
              f"counted on the card and in the dry-run (equal), 0 "
              f"collective bytes; peak {peak / 1e9:.3f} GB on the card "
              f"(max_memory_allocated), {got / 1e9:.3f} GB predicted "
              f"({got / peak - 1:+.3f}); replayed step "
              f"{real['replayed_ms']:.2f} ms against bound_s "
              f"{fk['bound_s'] * 1e3:.2f} ms ({fk['dominant']}): "
              f"{frac:.2f}x the bound | {smi}")
    seconds = time.perf_counter() - t0
    print(f"[dryrun] phase 12 took {seconds:.1f} s here (card child "
          f"{card['seconds']:.1f} s; the fake child {dry['seconds']:.1f} s, "
          f"run beside phase 11) | {smi}")
    launched = dict(card["launches"])
    for name, n in dry["launches"].items():
        launched[name] = launched.get(name, 0) + n
    return {"card": card, "fake": dry, "seconds": seconds,
            "launches": launched}


# --------------------------------------------------------------- phase 13 --
def _lint_path(device):
    d = SRC.parent / "build" / "lint"
    d.mkdir(parents=True, exist_ok=True)
    return d / f"{device}.json"


def _lint_start():
    """Starts phase 13's CPU pass (``python -m repro_torch.analysis.lint
    --all --device cpu``): it needs no card, and runs beside phases 11 and
    12 on one thread."""
    import os
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis.lint", "--all",
         "--device", "cpu", "--json", str(_lint_path("cpu"))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _lint_card_start():
    """Starts phase 13's card pass (``--lint card``), which takes the card
    and loads the kernels at once (beside phase 12) and runs the linter
    when phase 13 tells it to."""
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--lint", "card"], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _lint_card_child():
    """``python3 chip_smoke.py --lint card``: phase 13's card pass.  It
    imports the linter, the modules its entries build from and what the op
    log imports when it first starts, takes the card and loads the built
    kernels, prints ``ready``, and at a line on its standard input runs
    ``lint.main(["--all", "--device", "cuda", ...])``; its exit code is
    the linter's."""
    import importlib
    import torch
    from repro_torch.analysis import lint, traversal
    from repro_torch.kernels import _build
    for mod in ("core.fedfits", "core.async_engine", "core.pod",
                "serve.engine", "launch.serve", "data.pipeline",
                "optim.optimizers", "obs.counters"):
        importlib.import_module(f"repro_torch.{mod}")
    with traversal.OpLog():             # its imports (DTensor's planner,
        pass                            # the flop counter): ~10 s there
    torch.zeros(1, device=DEVICE)       # the context, before phase 12 ends
    torch.cuda.synchronize()
    _build.load()
    print("ready", flush=True)
    sys.stdin.readline()
    return lint.main(["--all", "--device", "cuda", "--json",
                      str(_lint_path("cuda"))])


def _lint_join(proc, device):
    try:
        out, err = proc.communicate(timeout=LINT_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        sys.stderr.write(out[-20000:] + err[-20000:])
        raise RuntimeError(f"phase 13 ({device} pass) failed (exit "
                           f"{proc.returncode})")
    with open(_lint_path(device)) as f:
        rep = json.load(f)
    s = rep["summary"]
    if (s["entries"], s["skipped"], s["errors"]) != (LINT_ENTRIES, 0, 0):
        raise AssertionError(f"[lint] {device}: {s} (want {LINT_ENTRIES} "
                             "entries, 0 skipped, 0 errors)")
    return rep


def _lint(smi, cpu, child):
    """Phase 13: the card pass (its child told to go), then the CPU pass
    joined; the same findings on both, and every expected kernel launched
    on the card."""
    t0 = time.perf_counter()
    try:
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError("phase 13's card child did not start")
        waited = time.perf_counter() - t0
        t0 = time.perf_counter()
        child.stdin.write("go\n")
        child.stdin.flush()
        card = _lint_join(child, "cuda")
    except BaseException:
        for proc in (cpu, child):
            proc.kill()
            proc.communicate()
        raise
    card_s = time.perf_counter() - t0
    host = _lint_join(cpu, "cpu")
    found = {d: {r["entry"]: sorted({(f["rule"], f["severity"])
                                     for f in r["findings"]})
                 for r in rep["results"]}
             for d, rep in (("cuda", card), ("cpu", host))}
    if found["cuda"] != found["cpu"]:
        raise AssertionError(f"[lint] findings differ: card {found['cuda']}"
                             f", CPU {found['cpu']}")
    meta, totals = card["meta"], {}
    for r in card["results"]:
        name = r["entry"]
        got = meta["launches"][name]
        want = meta["expected_launches"][name] or {}
        for k, n in got.items():
            totals[k] = totals.get(k, 0) + n
        silent = sorted(k for k, n in want.items() if n and not got.get(k))
        if silent:
            raise AssertionError(f"[lint] {name}: expected launches of "
                                 f"{silent} and none ran on the card")
        smem = ", ".join(f"{k} {b} B" if b is not None else f"{k} static"
                         for k, b in meta["smem"][name]) or "no kernel"
        captured = any(n.startswith("donation_audit: captured")
                       for n in r["notes"])
        print(f"[lint] {name}: {r['status']} on the card and the CPU, "
              f"{len(r['findings'])} findings"
              f"{', captured and replayed' if captured else ''}; launches "
              f"{json.dumps(got, sort_keys=True)} (expected "
              f"{json.dumps(want, sort_keys=True)}); shared memory a block "
              f"{smem} of the card's opt-in {meta['smem_optin']} B "
              f"(SMEM_LIMIT {meta['smem_limit']} B); "
              f"{meta['seconds'][name]:.2f} s on the card")
    print(f"[lint] phase 13: card pass {card_s:.1f} s from its go "
          f"({sum(meta['seconds'].values()):.1f} s in the entries; the "
          f"child started before phase 12, {waited:.1f} s waited here for "
          f"it to be ready), CPU pass "
          f"{sum(host['meta']['seconds'].values()):.1f} s in the entries, "
          f"beside phases 11-12 | {smi}")
    return {"seconds": card_s, "waited": waited, "launches": totals,
            "findings": found["cuda"]}


def main(argv=()):
    _import_port()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import tree
    from repro_torch.configs.paper_models import CNN_CONFIG
    from repro_torch.data.pipeline import build_federation
    from repro_torch.models.model import build

    if "--pod" in argv:             # phase 9 alone, as _pod runs it
        return _pod_child()
    if "--tp" in argv:              # phase 11 alone, as _tp runs it
        return _tp_child()
    if "--dryrun" in argv:          # phase 12 alone; a child with its part
        if "fake" in argv:
            return _dryrun_fake_child()
        if "card" in argv:
            return _dryrun_card_child()
        print(json.dumps({"dryrun": _dryrun(_smi(), _dryrun_start())},
                         default=float))
        return 0
    if "--lint" in argv:            # phase 13 alone; its card child
        if "card" in argv:
            return _lint_card_child()
        print(json.dumps({"lint": _lint(_smi(), _lint_start(),
                                        _lint_card_start())}))
        return 0
    if "--blocks" in argv:          # phase 10 alone, as _blocks runs it
        parts = [a for a in argv if a in ("models", "train")]
        if parts:
            return _blocks_child(parts[0])
        print(json.dumps({"blocks": _blocks(_smi())}))
        return 0
    smi = _card()
    model = build(CNN_CONFIG)
    cnn_sizes = [p.numel() for p in tree.leaves(model.init(torch.Generator()))]
    report = _kernels(cnn_sizes)
    flat_report, c96 = _k5_and_flat(cnn_sizes)
    for entry in report:
        if entry["name"] in c96:
            entry["c96"] = c96[entry["name"]]
    report += flat_report
    report.append(_topd_checks())
    report += _attention_kernels()
    if "--kernels" in argv:         # the kernel phases alone: no result line
        print(smi)
        print(json.dumps({"kernels": report}))
        return 0
    fed, test = build_federation(0, kind="images", n=4000, n_clients=16,
                                 batch_size=32)

    def evaluate(params):
        _, met = model.loss(params, test)
        return {"test_acc": met["acc"]}

    counts, dense_fedavg = _round(model, fed, evaluate)
    counts.update(_compressed_round(model, fed, evaluate, dense_fedavg))
    async_counts, async_side = _async_phase(model)
    counts["block_topd"] = async_counts["block_topd"]
    _parity(model, fed, evaluate, async_side)
    _timing(fed, async_side, smi)
    _telemetry(model, fed, evaluate, async_side, smi)
    del async_side
    robust_counts = _robustness()
    for entry in flat_report:
        counts[entry["name"]] = robust_counts[entry["name"]]
    box = []
    counts.update(_serving(smi, box))
    counts["flash_attention_fwd"] = _forward(box, smi)
    del box
    pod = _pod(smi)
    for name, n in pod["launches"].items():
        counts[name] += n
    blocks = _blocks(smi)
    for got in blocks["launches"].values():
        for name, n in got.items():
            counts[name] = counts.get(name, 0) + n
    if "pod" not in blocks["kernels"]:
        raise AssertionError("phase 10 did not time K1-K3 on granite's "
                             "buffer")
    fake = _dryrun_start()          # phase 12's dry-runs, beside 11
    lint_cpu = _lint_start()        # phase 13's CPU pass, beside 11-12
    tp = _tp(smi)
    for got in tp["launches"].values():
        for name, n in got.items():
            counts[name] = counts.get(name, 0) + n
    lint_card = _lint_card_start()  # phase 13's card child, waiting
    dry = _dryrun(smi, fake)
    lint = _lint(smi, lint_cpu, lint_card)
    for entry in report:
        name = entry["name"]
        entry["launches"] = counts[name]
        if name in pod["kernels"]:
            entry["pod"] = {**pod["kernels"][name],
                            "launches": pod["launches"].get(name, 0)}
        if name in blocks["kernels"]["pod"]:
            entry["granite_pod"] = blocks["kernels"]["pod"][name]
        if name in blocks["kernels"]:
            entry["blocks"] = blocks["kernels"][name]
        by_path = {path: got[name] for path, got in blocks["launches"].items()
                   if name in got}
        if by_path:
            entry["blocks_launches"] = by_path
        by_path = {path: got[name] for path, got in tp["launches"].items()
                   if name in got}
        if by_path:
            entry["tp_launches"] = by_path
        entry["dryrun_launches"] = dry["launches"][name]
        entry["lint_launches"] = lint["launches"].get(name, 0)
    print(f"[dryrun] phase 12: {dry['seconds']:.1f} s")
    print(f"[lint] phase 13: {lint['seconds']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
