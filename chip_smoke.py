#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: the quickest proof that
the port still builds, agrees with itself, trains and serves on the GPU.

    python3 chip_smoke.py [--rounds 4] [--profile-out DIR]

Phases, one JSON object per line on stdout:

1. probe   — Python, torch, CUDA, nvcc and the card (the raw
             ``nvidia-smi --query-gpu=name,power.limit`` line is printed on
             its own line as well);
2. build   — every kernel of the port (K1-K5) compiled from
             ``src/repro_torch/kernels/csrc`` with nvcc (one process each,
             in parallel), with ptxas' report; ``cuobjdump -sass`` counts
             K4's ``HGMMA`` and ``UTMALDG`` instructions and K5's
             ``HGMMA``, and the run fails if any of those is 0;
3. check   — each kernel against its plain PyTorch version on the card:
             K1 at the reference's test shapes, the SR leaf shapes and the
             flat lane buffer the round folds (f32 bitwise, bf16 within 1
             ulp); K2 at the reference's sweep shapes and weight edges and
             on the SR flat buffer with its 18-leaf scale table (f32
             bitwise; ``N+n == 0`` returns ``acc`` bit for bit); K3 and K4
             over the reference's sweeps in f32 and bf16 and at the serve
             path's shapes (2e-5 f32, 2e-2 bf16, as tests/test_kernels.py;
             K4 at the qwen3, granite-moe and internvl2 serve shapes, 8e-3
             in bf16),
             K4 also on its wgmma route's bf16 cases (d 64 and 128, ragged
             s and t, GQA groups 1-8, non-causal, fused q/k/v views), each
             case on the route its dtype and head dim name, and a
             misaligned bf16 input must raise;
             K5, y and the final state, over the reference's sweep in f32
             and bf16, at the SSM serve shape in f32 and bf16 and a
             1,000-row prompt, and on its wgmma route's bf16 cases (p 64:
             chunks shorter than 128, GQA groups, n 16 and 40, a prompt
             shorter than a chunk), each case on the route its dtype and
             widths name (``SSD_TOL``);
4. timing  — each kernel, its plain version and, where one exists, one
             library call at the main paths' shapes (CUDA events, best of
             3 interleaved), beside the bytes/ops bound; K4 at the three
             serve shapes (qwen3: 16 heads of 128; granite-moe: 24 of 64,
             group 3; internvl2: 48 of 128 over 2,304 positions, group
             6);
5. main    — ``build_engine(task="sr")`` at the published SR widths on
             ``cuda``: rounds at pipeline depth 1 and again at depth 0 from
             the same seed, with the launch counts zeroed just before each
             run and read just after; losses must be finite and
             bit-identical, and every round step must have gone through K1;
6. mesh    — ``build_engine(task="sr", workers=4, mesh_workers=2,
             combine_mode="tree", combine_compress="int8")`` at the
             published widths, ``MESH_ROUNDS`` rounds at depth 1 and again
             at depth 0: finite losses, bit-identical across depths, K2
             launched once per live shard per round, ``combine_bytes`` 2 ×
             4,245,072 B per round, K1 once per worker program step;
7. decomp  — the flat combine at ``mesh_workers`` 2 and 4 against the
             fused path (4 workers), bitwise; ``hosts=1`` against
             ``hosts=2`` at ``mesh_workers=4`` with ``combine_compress``
             ``none`` and ``int8``, bitwise; one topk round;
8. agree   — a small SR engine on the card against the same engine on the
             CPU (rtol 1e-4: GEMM sums are ordered differently);
9. serve   — the LM serve path: qwen3-0.6b at its published widths and
             full depth in bf16 with ``attn_impl="pallas"``, weights from
             ``init_params(0)``; with the launch counts zeroed just before
             and read just after: one prefill of 4 × 2,048 tokens (K4
             exactly 28 launches), 16 greedy decode steps (no K4), and K3
             through ``rms_norm(impl="pallas")`` on the serve path's own
             norm inputs; K4's 28 prefill launches all on the wgmma route;
             finite logits; then the pallas prefill against
             the dense one, prefill + decode against a teacher-forced
             ``forward``, and a 1,000-token prompt (``SERVE_TOL``); a
             profiled prefill and decode step (device idle share);
10. agree LM — the reduced qwen3-0.6b serve path on the card against the
             same on the CPU (``AGREE_LM_TOL``);
11. serve SSM — mamba2-2.7b at its published widths and full depth in bf16
             with ``ssd_impl="pallas"``, weights from ``init_params(0)``
             (2.7 B drawn on the CPU), the same traffic as phase 9, with
             the launch counts zeroed just before and read just after: K5
             exactly 64 launches in the prefill, all on its wgmma route,
             and none in decode; finite
             logits; the pallas prefill against the chunked one (logits and
             the SSM state of every layer), prefill + decode against
             ``forward`` and a 1,000-token prompt, in bf16
             (``SSM_BF16_TOL``) and again with the same weights in f32
             (``SSM_F32_TOL``), each bf16 prefill's distance from the f32
             one reported; a
             profiled prefill and decode step (device idle share, K5's
             share);
12. agree SSM — the reduced mamba2-2.7b serve path on the card against the
             same on the CPU (``AGREE_LM_TOL``);
13. serve MoE — granite-moe-3b-a800m at its published widths and full
             depth in bf16 (3,299,182,080 params from ``init_params(0)``,
             drawn on the CPU) with ``attn_impl="pallas"`` and
             ``moe_impl="scatter"``, the same traffic as phase 9, the
             launch counts zeroed just before and read just after: K4
             exactly 32 launches in the prefill, all on its wgmma route,
             and none in decode; finite logits; the prefill's dropped-slot
             share at capacity factor 1.25, per layer and in all; the
             pallas prefill against the dense one, a dropless prefill +
             decode against a dropless ``forward``, and a 1,000-token
             prompt, in bf16 (``MOE_BF16_TOL``) and with the weights
             upcast to f32 (``MOE_F32_TOL`` on tokens clear of routing
             near-ties), each with the count of (token, layer) routing
             decisions that differ; a profiled prefill and decode step
             (device idle share, K4's and the dispatch passes' shares);
14. agree MoE — the reduced granite-moe, qwen3-moe (scatter) and jamba
             (K5 and MoE in one stack) serve paths on the card against the
             same on the CPU (``AGREE_LM_TOL``);
15. serve audio — whisper-base at its published size (73,596,928 params,
             bf16, ``attn_impl="dense"``): 4 clips of 1,500 frame
             embeddings with 448-token prompts, one prefill and 16 greedy
             decode steps, launch counts zeroed just before and read just
             after (none: dense attention); finite logits; prefill +
             decode against ``forward`` (``SERVE_TOL``); ``"pallas"``
             raises ``NotImplementedError`` before any launch; a profiled
             prefill and decode step; then the reduced whisper card vs CPU
             (``AGREE_LM_TOL``);
16. serve VLM — internvl2-26b at its published widths cut to 12 of 48
             layers (5,839,411,200 params, bf16, ``attn_impl="pallas"``):
             4 × (256 patch embeddings of width 3,200 + 2,048 tokens), one
             prefill (K4 exactly 12 launches, all on wgmma) and 16 greedy
             decode steps (no K4); finite logits; pallas vs dense prefill
             and prefill + decode vs ``forward`` (``SERVE_TOL``); a
             profiled prefill and decode step (where the prefill's device
             time goes); then the reduced internvl2 card vs CPU;
17. train LM — federated LM training through the CLI,
             ``main(["--arch", A, "--preset", "fl100m", ...])`` for
             qwen3-0.6b (3 rounds), mamba2-2.7b, granite-moe-3b-a800m,
             whisper-base and internvl2-26b (2 rounds each; granite: 12
             layers of 4 experts top-2, 2,048 wide, 269,998,848 params,
             the einsum dispatch; whisper: 2 encoder layers over 16
             frames, cross-attention, 256 learned positions; internvl2: 16
             patches of width 32 in front of the 256 tokens) at depth 1,
             then depth 0, from the same seed, the launch counts zeroed
             just before each run and read just after: finite losses,
             bit-identical across depths, K1 exactly once per lane-loop
             step; ``exec_time`` per round and the run's peak memory; the
             granite loss holds its load-balance term;
18. train LM mesh — the same qwen3 with ``--workers 4 --mesh-workers 2
             --combine-mode tree --combine-compress int8``, 2 rounds at
             depths 1 and 0: bit-identical losses, K2 once per live shard
             per round over the LM's leaf table, K1 once per worker-program
             step, ``combine_bytes_per_round`` 2 × the int8 payload;
19. train LM full width — qwen3-0.6b at its published widths (596,180,992
             params from ``init_params(0)``) in f32 through
             ``build_engine(lm_cfg=..., preset="fl100m")``: batches of 8 ×
             256 tokens, cohort 4 on 1 worker × 2 lanes, ``steps_cap`` 4
             (no padded step), 2 rounds at depths 1 and 0 (cut to size:
             f32 where bf16 is published, 2 lanes, 2 rounds): finite,
             bit-identical losses, K1 once per step over ``[2,
             596,180,992]`` f32, peak device memory, ``exec_time`` and its
             time per real lane step, a profiled round (device busy, idle
             share, top kernels, K1's share); then K1 at that shape
             against its plain version (bitwise) and timed with
             ``torch.lerp`` beside the bound, and K2 on the fl100m
             payload's fold (bitwise, timed);
20. agree train — a reduced qwen3-0.6b training engine, 2 rounds on the
             card against the same on the CPU: losses within
             ``AGREE_TRAIN_RTOL``, the final params leaf by leaf within
             ``AGREE_TRAIN_PARAMS``, and the initial params outside it;
21. train tasks — the paper's other three tasks at their full sizes
             (IC 300,032, TG 9,244,672 and MLM 11,339,776 params) through
             ``build_engine(task=t)``'s defaults (cohort 8 over 2 workers ×
             2 lanes, ``steps_cap`` 8, LB, FedAvg; SGD for IC and TG, Adam
             at 4e-5 for MLM), 2 rounds at depth 1, then depth 0, the
             launch counts zeroed just before each run and read just
             after: finite losses, bit-identical across depths, K1 exactly
             once per lane-loop step; ``exec_time`` per round, peak
             memory, a profiled round, and K1 timed at the task's ``[4,
             N]`` lane buffer;
22. fedmedian — ``build_engine(task="sr", strategy="fedmedian")`` at the
             published widths, 3 rounds at depths 0 and 1: bit-identical
             losses, no kernel launched (the gather path folds nothing),
             the card's median of one round's ``[4, N]`` models bitwise
             equal to the CPU's — and with a NaN and ±inf put into them,
             NaN exactly where a column holds a NaN, bitwise elsewhere —
             and the reduce timed;
23. resume — SR fused and the int8 mesh path: 4 rounds with a checkpoint
             every 2, restored into a new engine for 2 more, bitwise
             equal to rounds 4-5 of an uninterrupted run (K2 2 a round on
             the resumed mesh rounds, the residuals in the ``.aux.npz``
             sidecar); the checkpoint's bytes and its save time;
24. agree tasks — reduced IC, TG and MLM engines, 2 rounds on the card
             against the same on the CPU (``AGREE_TASKS_RTOL``);
25. control — the closed loop on SR at its published widths (K1 folding
             every lane-loop step), the launch counts zeroed just before
             each run and read just after: measured telemetry on the
             fused path at depths 0/1/2 under ``reuse`` and ``stall``
             (``CONTROL_ROUNDS`` rounds each): the refit barrier's audit
             clean, no stall at depth <= 1, the LB model fed from the
             card's round times, K1 once per lane-loop step (counted, and
             from the profiler's kernel events in a profiled round);
             measured telemetry on the mesh path (flat, and tree with int8
             uploads): exact per-worker times, a residual per worker, the
             audit clean; synthetic telemetry with the drift fallback and
             the hill climber live at depths 0/1/2: losses bitwise, the
             fallback engaged, every slot move in the worker pool;
26. population — ``--sampler online --population 1000000 --cohort 64``
             with a global outage over rounds [2, 4) and the controller
             live, at depths 0/1/2: SLO fields and losses identical,
             ``stale_fraction`` > 0 exactly inside the window, O(cohort)
             probes, the prep time a round; a resume from a checkpoint
             replays the stream (cohorts, SLO fields, losses) bitwise with
             the controller's state restored;
27. memory probe — ``round_memory_analysis`` of SR and MLM at 1 and 2
             lanes (argument, output and temp bytes from the allocator),
             the slot estimate for this card and for the default 80 GB
             spec, then one SR round at ``min(estimate, 64)`` lanes on one
             worker whose peak must stay within the estimate's budget;
28. cache — the device batch cache (PR 22) on SR at its published widths
             under a Zipf draw of 64 clients a round (gradients clipped
             at 1), 12 rounds: off, 512 rows, and a byte budget holding
             the whole population (7,656 batches of 5,200 B), each at
             depths 0/1/2: losses bitwise
             the cache-off run's, K1 = Σ ``s_steps``, bytes saved = hit
             steps × 5,200; the hit rate, ``pack_time`` and bytes copied
             a round on and off, the assembly's device ms (CUDA events),
             a profiled round;
29. cache mesh — 4 workers over 2 shards, tree, int8, 256 rows, cache
             affinity, at depths 1 and 0 (bitwise; per-shard sums; K2 once
             per live shard a round); without affinity cache on == off
             bitwise; 3 rounds card vs CPU recorded; the same options on
             the agree phase's small engine, 6 rounds card vs CPU within
             rtol 1e-4; the reclaim scenario (capacity rows [32, 32] →
             [64, 0] → [32, 32]);
30. multihost — ``run_multihost(build_engine, ...)``: two spawned ranks on
             the card, bitwise the in-process ``hosts=1`` run, each rank
             running only its own block; rank 1 killed inside round 3's
             exchange (``ok=False``, a flight dump) and a bitwise resume
             from rank 0's checkpoint; the exchange's ms and bytes;
31. the ``kernels`` line (K1-K5; K1's and K2's launches on the LM training,
   task, FedMedian, resume and cache paths beside the main ones, K1 timed
   at the tasks' lane buffers, K4's launches on the MoE and VLM serve paths
   and its timing at those shapes), then the card line and the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failed phase raises, so the script exits non-zero and prints no last
line.  It also fails where no CUDA card is present, and where the repo's
``src/`` is missing.  ``--profile-out DIR`` adds a torch.profiler pass over
two rounds of the main path (``DIR/fused``) and of the mesh path
(``DIR/mesh``): the trace, per-kernel device time and per-op host time.
"""

from __future__ import annotations

import os

# cuBLAS reads this when it creates its first handle; set before anything
# touches CUDA so GEMMs are deterministic (bit-identity across depths).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

# Published peaks (NVIDIA data sheets, dense): memory bytes/s by card, and
# the non-tensor-core f32 rate of an H100.  Used for bound_ms only.
MEM_BW = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
          ("H100", 3.35e12))
F32_FLOPS = 67e12
# The SR leaf shapes (input 64, width 512, 35 classes) and the JAX sweep.
SR_LEAVES = [(64, 512), (512, 512), (512, 35)]
SWEEP = [(7,), (33,), (300, 5), (129, 1025), (2, 3, 5, 7), (4096,)]
EDGES = [(0.0, 0.0), (0.0, 4.0), (7.0, 0.0), (10.0, 3.0)]
SR_PARAMS = 4_244_992
# The slice's path: 4 workers x 2 lanes over 2 shards, tree combine, int8.
MESH = dict(workers=4, mesh_workers=2, combine_mode="tree",
            combine_compress="int8")
MESH_ROUNDS = 3
INT8_PAYLOAD = 4_245_072      # payload_nbytes(SR, "int8"): N + 18*4 + 8
# The dense bf16 tensor-core peak of an H100 SXM (for K4's bound).
BF16_FLOPS = 989e12
# K3/K4 sweeps of the reference (tests/test_kernels.py:90 and :104-107):
# rmsnorm shapes; attention (b, s, hq, hkv, d).
RMS_SWEEP = [(4, 64), (2, 3, 128), (5, 256), (1, 512)]
ATTN_SWEEP = [(2, 128, 4, 2, 32), (1, 100, 8, 8, 16), (2, 260, 6, 2, 64),
              (1, 512, 2, 1, 128)]
# The serve path: qwen3-0.6b at its published widths and full depth, bf16;
# 4 requests of 2,048 prompt tokens, then 16 greedy decode steps.
SERVE_ARCH = "qwen3-0.6b"
SERVE_PARAMS = 596_180_992    # the reference's count (152,064-row embed)
SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE = 4, 2048, 16
SERVE_MAX_LEN = SERVE_PROMPT + SERVE_DECODE
RAGGED_PROMPT = 1000          # not a multiple of the reference's kv block
# bf16 logits of the serve path (std ~0.6, |max| ~3) compared across two
# routes through 28 layers: each route rounds its activations to bf16
# (2^-9 relative) at other places, and those differences compound over the
# layers.  A wrong kernel moves logits by O(1).
SERVE_TOL = dict(atol=0.1, rtol=0.05)
# Card vs CPU on the reduced f32 serve path: the same math, GEMM sums and
# the kernels' sums in another order (the CPU parity tests measured ~3e-6
# port vs reference).
AGREE_LM_TOL = dict(atol=1e-4, rtol=1e-4)
# The SSM serve path: mamba2-2.7b at its published widths and full depth,
# bf16, ssd_impl="pallas", the same traffic as the qwen3 serve path.
SSM_ARCH = "mamba2-2.7b"
SSM_PARAMS = 2_702_624_256    # the reference's count (50,432-row embed)
# K5 over the reference's sweep (tests/test_kernels.py:139-143): (b, s, h,
# p, g, n, chunk), then the serve shape and a ragged 1,000-row prompt at
# mamba2-2.7b's widths (80 heads of 64, one group, state 128, chunk 128).
SSD_SWEEP = [(2, 64, 4, 16, 2, 32, 16), (1, 100, 8, 32, 1, 64, 32),
             (2, 128, 4, 64, 4, 16, 128)]
SSD_SERVE = (SERVE_BATCH, SERVE_PROMPT, 80, 64, 1, 128, 128)
SSD_RAGGED = (1, RAGGED_PROMPT, 80, 64, 1, 128, 128)
# K5's wgmma route (bf16 at p 64) beyond those: a chunk of 32 padded to 128
# rows, GQA groups with n 64, a prompt shorter than one chunk, jamba's n 16,
# and n 40 (zero-padded to 64 columns) at chunk 16.
SSD_WGMMA = [(1, 100, 8, 64, 1, 128, 32), (2, 300, 4, 64, 2, 64, 128),
             (1, 50, 4, 64, 1, 128, 128), (2, 512, 8, 64, 1, 16, 128),
             (1, 70, 3, 64, 1, 40, 16)]
# K5 against its plain version (the same chunk loop, sums in another
# order).  f32: outputs reach ~30 on the sweep's draws and the f32 sums
# agree to ~1e-6 of that, so 1e-4 is tight.  bf16: both round the same f32
# sums to bf16, so they differ by at most one bf16 step, 2^-7 of the value:
# rtol 8e-3; atol 1e-3 for outputs near zero.  A wrong kernel (a dropped
# D x or state term) moves outputs of ~1 by ~0.1.
SSD_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
           "bfloat16": dict(atol=1e-3, rtol=8e-3)}
# The SSM serve path's route checks (K5 vs the chunked SSD, prefill +
# decode vs forward, the ragged prompt), on logits up to ~5.  In f32 (the
# same weights upcast): two sound routes differ in the f32 roundings of
# their sums (~1e-7 relative), however those grow over 64 layers: 1e-3
# leaves them a hundredfold room and catches any real fault.  In bf16 (the
# served dtype) a rounding moved to the neighbouring bf16 value (2^-9
# relative) grows through 64 layers of random weights: two sound bf16
# routes differ by up to 0.30 on logits up to 4.7 (measured on the H100),
# so bf16 is held at atol 0.5 + rtol 0.05.  Each bf16 prefill's distance
# from the f32 one is reported beside them.
SSM_F32_TOL = dict(atol=1e-3, rtol=1e-3)
SSM_BF16_TOL = dict(atol=0.5, rtol=0.05)
# The MoE serve path: granite-moe-3b-a800m at its published widths and full
# depth in bf16 with attn_impl="pallas", the same traffic as the qwen3 serve
# path.  Cut to size: moe_impl="scatter", the reference's own knob (qwen3-moe
# and jamba set it), which computes the same function: at T = 8,192 tokens
# the default "einsum" would build a [8192, 8, 40, 2048] one-hot (10.7 GB in
# bf16) and ~16 PFLOP of dispatch products a layer.  No width is cut.
MOE_ARCH = "granite-moe-3b-a800m"
MOE_PARAMS = 3_299_182_080    # the reference's count (49,408-row embed)
# A routing decision is discontinuous: where a token's k-th and (k+1)-th
# router probabilities nearly tie, two sound routes (sums in other orders)
# may pick another expert for it and move its output by O(gate x expert
# output), not by roundings.  Each route check reports the (token, layer)
# decisions that differ.  In f32 (the weights upcast) two sound routes
# differ by f32 roundings (~1e-7 relative) grown over 32 layers: the
# logits are held at SSM_F32_TOL on the compared tokens whose gap exceeds
# MOE_F32_TIE_GAP at every layer in both routes.  In bf16 the router logits
# carry 8 significant bits, so nearly every token ties within bf16 noise
# at one of 32 layers: all compared tokens are held, at SSM_BF16_TOL (bf16
# roundings grown through 32 random-weight layers, and near-tie flips).
MOE_F32_TOL = SSM_F32_TOL
MOE_BF16_TOL = SSM_BF16_TOL
MOE_F32_TIE_GAP = 1e-5
# Kernel-name fragments of the MoE dispatch passes in a profile: the
# router's top-k sort and the scatter's index sort, the position cumsum,
# the one-hot, and the scatter-add and gather of the token rows.
MOE_DISPATCH_KERNELS = {"moe_sort": ("sort", "Sort"),
                        "moe_cumsum": ("scan", "Scan"),
                        "moe_scatter_gather": ("scatter", "index", "Index",
                                               "gather")}
# The audio encoder-decoder: whisper-base (arXiv:2212.04356) at its
# published size, nothing cut: 4 clips of 1,500 frame embeddings (the stub
# of its conv frontend, 30 s of audio) with 448-token prompts (its text
# context), bf16.  attn_impl="dense", the reference's default: the encoder
# and the cross-attention are non-causal over 1,500 keys, which the kernel
# wrapper would pad, and both packages refuse that
# (repro/kernels/ops.py:129-131); the phase checks that "pallas" raises.
AUDIO_ARCH = "whisper-base"
AUDIO_PARAMS = 73_596_928     # the reference's count (51,968-row embed)
AUDIO_PROMPT = 448
# The VLM: internvl2-26b (arXiv:2404.16821) at every published width, bf16,
# attn_impl="pallas"; 4 requests of 256 patch embeddings (one ViT tile,
# InternViT-6B width 3,200, the stub of its vision tower) in front of 2,048
# tokens.  Cut to 12 of its 48 layers: the weights are drawn on the CPU at
# ~36-46 M values/s, and 19.9 B would take 430-550 s of the script's time.
VLM_ARCH = "internvl2-26b"
VLM_LAYERS = 12
VLM_PARAMS = 5_839_411_200    # the reference's count at 12 layers
# Federated LM training (--arch, f32 as the reference trains): the
# reference's fl100m preset through the CLI (qwen3 for 3 rounds, mamba2,
# granite-moe, whisper and internvl2 for 2, its default cohort 8 over 2
# workers x 2 lanes), the mesh path with
# int8 shard uploads (4 workers over 2 shards), and qwen3-0.6b at its
# published widths through the same builder at the fl100m preset's "lm"
# batches of 8 x 256 tokens, cohort 4 on 1 worker x 2 lanes, 4 local steps
# a client: 2 clients a lane fill the S = 8 bucket with no padded step.
LM_TRAIN = (("qwen3-0.6b", 3), ("mamba2-2.7b", 2), (MOE_ARCH, 2),
            (AUDIO_ARCH, 2), (VLM_ARCH, 2))
LM_MESH_ARGS = ["--workers", "4", "--mesh-workers", "2", "--combine-mode",
                "tree", "--combine-compress", "int8"]
LM_MESH_ROUNDS = 2
FULL = dict(preset="fl100m", cohort=4, workers=1, concurrency=2,
            steps_cap=4, seed=0)
FULL_ROUNDS = 2
# Card vs CPU on a reduced LM engine: the same math, GEMM and reduction
# sums in another order, over 2 rounds of SGD.  The final params are held
# leaf by leaf at the tolerance the CPU tests hold the port's engine to
# against the reference's; the initial params must fail that check (a
# round that left them unchanged could not pass).
AGREE_TRAIN_RTOL = 1e-6
AGREE_TRAIN_PARAMS = dict(rtol=1e-4, atol=1e-6)
# The paper's other three tasks at their full sizes (parameter counts are
# the reference's), through build_engine's defaults: cohort 8 over 2
# workers x 2 lanes, steps_cap 8, LB, FedAvg, each task's reference
# optimizer (MLM through Adam).
TASK_PARAMS = {"ic": 300_032, "tg": 9_244_672, "mlm": 11_339_776}
TASK_ROUNDS = 2
FEDMEDIAN_ROUNDS = 3
# Resume: 4 rounds with a checkpoint every 2, then 2 more in a new engine,
# against rounds 4-5 of an uninterrupted run.
RESUME_ROUNDS, RESUME_EVERY = 4, 2
# The closed loop on SR (published widths, build_engine's defaults: cohort
# 8 over 2 workers x 2 lanes): rounds per run; the synthetic controller's
# hair-trigger drift threshold and hill-climb interval; the slot cap of
# the climber (EngineConfig.adapt_max_slots).
CONTROL_ROUNDS = 8
CONTROL_DRIFT, CONTROL_ADAPT = 0.01, 2
CONTROL_MAX_SLOTS = 64
# The open-world population: 1,000,000 registered clients, cohorts of 64,
# every region offline over rounds [2, 4) (the stale fill), 6 rounds at
# each depth; the resume checkpoints at round 4.
POP_CLIENTS, POP_COHORT, POP_OUTAGE = 1_000_000, 64, "2:4"
POP_ROUNDS, POP_RESUME_AT = 6, 4     # the resume replays rounds 4-5
# Card vs CPU on reduced task engines (the CPU tests' widths): the same
# math, GEMM and reduction sums in another order, over 2 rounds; TG's
# recurrence (12 positions) and MLM's softmax stay well inside 1e-5.
TASK_SMALL = {"ic": dict(width=32, n_blocks=2),
              "tg": dict(vocab=90, hidden=16),
              "mlm": dict(vocab=512, d_model=32, n_layers=2, d_ff=64)}
AGREE_TASKS_RTOL = 1e-5
# The device batch cache (PR 22): SR at its published widths under a Zipf
# draw of 64 clients a round (hot clients recur), 12 rounds; the cache off,
# 512 rows, and a byte budget that holds every batch of the population.
# A batch row is x [20, 64] f32 + y [20] int32 (``_probe_row_bytes``).
# The Zipf head draws clients whose local SGD diverges at SR's learning
# rate, cache on or off, in the reference as in the port: on the
# reference's data and weights both give NaN in round 0 without a clip
# (``tests/_torch_sr_zipf_reference.py``).  So these runs clip each step's
# gradient at global norm 1 (``--grad-clip 1.0``), as the reference's
# heavier Zipf recipe (exponent 1.6) does; its cache recipe sets none.
CACHE_ROUNDS, CACHE_COHORT, CACHE_ROWS = 12, 64, 512
CACHE_KW = dict(sampler="zipf", grad_clip=1.0)
SR_ROW_BYTES = 5_200
# The cache on the mesh path: the int8 tree mesh with 256 rows over its 2
# shards and cache-aware placement.  Card vs CPU at SR's rtol on the agree
# phase's small engine with the same options (at the published widths an
# int8 code at a rounding edge turns a 1e-7 difference into ~1e-3 within
# two rounds, cache on or off: recorded, not held).
CACHE_MESH = dict(MESH, **CACHE_KW, device_cache_batches=256,
                  cache_affinity=True)
CACHE_MESH_ROUNDS, CACHE_AGREE_ROUNDS = 6, 3
# The process-per-host harness: tests/test_multihost.py:26's kwargs (SR, 4
# workers over 4 shards, tree, no compression, steps_cap 4, seed 13), two
# ranks on the one card.
MULTIHOST = dict(task="sr", workers=4, mesh_workers=4, pipeline_depth=1,
                 combine_mode="tree", combine_compress="none", steps_cap=4,
                 seed=13, hosts=2, device="cuda")
MULTIHOST_ROUNDS = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def mem_bw(name: str) -> float:
    for key, bw in MEM_BW:
        if key in name:
            return bw
    return 3.35e12


_sleep_cycles_per_ms: list = []


def _cycles_per_ms(torch) -> float:
    """The rate of ``torch.cuda._sleep``'s cycle count, timed once on the
    card with CUDA events."""
    if not _sleep_cycles_per_ms:
        cycles = 20_000_000
        torch.cuda._sleep(cycles)                # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _sleep_cycles_per_ms.append(cycles / start.elapsed_time(end))
    return _sleep_cycles_per_ms[0]


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls.

    A call's host side (the wrapper's checks, allocation, the launch) can
    take longer than its kernels; the card would then wait for the host
    between calls and the events would time the host.  So the timed calls
    are queued behind a device-side sleep twice as long as their enqueue
    took, and the card runs them back to back."""
    import torch
    rate = _cycles_per_ms(torch)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * enqueue_ms * rate))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _best_of(runs: dict, orders, **kw) -> dict:
    """Each run's best :func:`time_ms` over the given interleaved orders
    (a run that is None stays None)."""
    best = {k: math.inf for k in runs}
    for order in orders:
        for k in order:
            if runs[k] is not None:
                best[k] = min(best[k], time_ms(runs[k], **kw))
    return {k: (None if v == math.inf else v) for k, v in best.items()}


def phase_probe(torch):
    smi = nvidia_smi()
    print(smi, flush=True)
    from repro_torch.kernels import build
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    emit({"phase": "probe", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc, "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count()})
    return smi


def sass_counts(lib: str) -> dict:
    """Tensor-core (``HGMMA``) and TMA-load (``UTMALDG``) instructions in a
    library's SASS, from ``cuobjdump -sass`` beside nvcc."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return {op: sum(op in ln for ln in sass.splitlines())
            for op in ("HGMMA", "UTMALDG")}


def phase_build() -> tuple[dict, dict]:
    """Builds K1-K5; returns K4's SASS counts, which must show wgmma and
    TMA loads, and K5's, which must show wgmma."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    info = build.build_all()
    sass = sass_counts(info["flash_attention"]["path"])
    sass5 = sass_counts(info["ssd"]["path"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"seconds": v["seconds"], "cached": v["cached"],
                             "ptxas": [ln.strip() for ln in
                                       v["log"].splitlines()
                                       if "registers" in ln or "spill" in ln]}
                      for name, v in info.items()},
          "flash_attention_sass": sass, "ssd_sass": sass5})
    check(sass["HGMMA"] > 0 and sass["UTMALDG"] > 0,
          f"K4's library has no wgmma or no TMA load: {sass}")
    check(sass5["HGMMA"] > 0, f"K5's library has no wgmma: {sass5}")
    return sass, sass5


def _bf16_ulps(torch, a, b) -> int:
    return int((a.view(torch.int16).int()
                - b.view(torch.int16).int()).abs().max())


def phase_check(torch, n_params: int, lanes: int) -> float:
    """K1 against its plain version; returns the max |err| in f32."""
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cases, max_err = 0, 0.0
    shapes = SWEEP + SR_LEAVES
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes:
            acc = torch.randn(shape, generator=gen).to(dtype).to(dev)
            theta = torch.randn(shape, generator=gen).to(dtype).to(dev)
            for n_old, n_k in EDGES:
                got = ops.fedavg_accum(acc, theta, n_old, n_k)
                want = ref.fedavg_accum_ref(acc, theta, n_old, n_k)
                torch.cuda.synchronize()
                cases += 1
                if dtype == torch.float32:
                    err = float((got - want).abs().max())
                    max_err = max(max_err, err)
                    check(torch.equal(got, want),
                          f"K1 f32 {shape} ({n_old},{n_k}): max err {err}")
                else:
                    ulps = _bf16_ulps(torch, got, want)
                    check(ulps <= 1, f"K1 bf16 {shape} ({n_old},{n_k}): "
                                     f"{ulps} ulps")
    # The round's own call: the flat [L, N] lane buffer with [L] weights
    # that cover every edge at once.
    acc = torch.randn(lanes, n_params, generator=gen).to(dev)
    theta = torch.randn(lanes, n_params, generator=gen).to(dev)
    n_old = torch.tensor([0.0, 7.0, 0.0, 3.5][:lanes], device=dev)
    n_k = torch.tensor([0.0, 0.0, 4.0, 2.0][:lanes], device=dev)
    got = ops.fedavg_accum(acc, theta, n_old, n_k)
    want = ref.fedavg_accum_ref(acc, theta, n_old, n_k)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    check(torch.equal(got, want), f"K1 flat [{lanes}, {n_params}]: {err}")
    emit({"phase": "check", "kernel": "fedavg_accum", "cases": cases + 1,
          "f32": "bitwise", "bf16": "<= 1 ulp", "max_abs_err_f32": max_err})
    return max_err


def phase_timing(torch, n_params: int, lanes: int, device_name: str) -> dict:
    """K1, its plain version and torch.lerp on the round's [L, N] call."""
    from repro_torch.kernels import fedavg_accum as fa
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    acc = torch.randn(lanes, n_params, generator=gen).to(dev)
    theta = torch.randn(lanes, n_params, generator=gen).to(dev)
    n_old = torch.full((lanes,), 6.0, device=dev)
    n_k = torch.full((lanes,), 3.0, device=dev)
    lerp_w = (n_k / (n_old + n_k))[:, None]
    runs = {"kernel": lambda: fa.fedavg_accum_lanes(acc, theta, n_old, n_k),
            "plain": lambda: ref.fedavg_accum_ref(acc, theta, n_old, n_k),
            "library": lambda: torch.lerp(acc, theta, lerp_w)}
    best = _best_of(runs, (("kernel", "plain", "library"),
                           ("library", "plain", "kernel"),
                           ("kernel", "plain", "library")))
    elems = lanes * n_params
    nbytes = 3 * elems * acc.element_size()      # 2 reads + 1 write
    bw = mem_bw(device_name)
    bytes_ms = nbytes / bw * 1e3
    ops_ms = 4 * elems / F32_FLOPS * 1e3         # 2 mul, 1 add, 1 div
    out = {"ms": best["kernel"], "plain_ms": best["plain"],
           "library_ms": best["library"],
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "shape": [lanes, n_params], "bytes": nbytes,
           "mem_bw_assumed": bw}
    out["achieved_gbs"] = nbytes / (best["kernel"] * 1e-3) / 1e9
    out["roofline_share"] = out["bound_ms"] / best["kernel"]
    emit({"phase": "timing", "kernel": "fedavg_accum", **out})
    return out


def _sr_layout():
    from repro_torch.kernels.layout import FlatLayout
    from repro_torch.models.papertasks import make_task_model
    params, _ = make_task_model("sr", 0, device="cpu")
    return FlatLayout(params)


def _payload(torch, n: int, gen, dev):
    acc = torch.randn(n, generator=gen).to(dev)
    g = torch.randn(n, generator=gen).to(dev)
    q = torch.randint(-127, 128, (n,), generator=gen,
                      dtype=torch.int8).to(dev)
    return acc, q, g


def phase_check_k2(torch, layout) -> float:
    """K2 against its plain version; returns the max |err| (f32)."""
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    cases, max_err = 0, 0.0

    def compare(got, want, acc, tag, edge):
        nonlocal cases, max_err
        torch.cuda.synchronize()
        cases += 1
        err = float((got - want).abs().max()) if got.numel() else 0.0
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"K2 {tag} {edge}: max err {err}")
        if edge[0] + edge[1] == 0.0:
            check(torch.equal(got, acc), f"K2 {tag}: N+n == 0 changed acc")

    for shape in SWEEP:
        n = math.prod(shape)
        acc, q, g = _payload(torch, n, gen, dev)
        acc, q, g = acc.view(shape), q.view(shape), g.view(shape)
        for edge in EDGES:
            got = ops.dequant_merge(acc, q, g, 0.013, *edge)
            want = ref.dequant_merge_ref(acc, q, g, 0.013, *edge)
            compare(got, want, acc, shape, edge)
    # The combine's own call: the SR flat buffer, 18 per-leaf scales.
    acc, q, g = _payload(torch, layout.n, gen, dev)
    scales = (torch.rand(len(layout.names), generator=gen) * 0.02).to(dev)
    offsets = layout.offsets_on(dev)
    for edge in EDGES:
        n_old, n_k = (torch.tensor(w, device=dev) for w in edge)
        got = ops.dequant_merge_flat(acc, q, g, scales, offsets, n_old, n_k)
        want = ref.dequant_merge_flat_ref(acc, q, g, scales, offsets,
                                          n_old, n_k)
        compare(got, want, acc, f"SR flat [{layout.n}]", edge)
    emit({"phase": "check", "kernel": "dequant_merge", "cases": cases,
          "f32": "bitwise", "max_abs_err_f32": max_err})
    return max_err


def phase_timing_k2(torch, layout, device_name: str) -> dict:
    """K2 and its plain version on one shard's SR payload fold."""
    from repro_torch.kernels import dequant_merge as dm
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    acc, q, g = _payload(torch, layout.n, gen, dev)
    scales = (torch.rand(len(layout.names), generator=gen) * 0.02).to(dev)
    offsets = layout.offsets_on(dev)
    n_old = torch.tensor(6.0, device=dev).reshape(1)
    n_k = torch.tensor(3.0, device=dev).reshape(1)
    runs = {"kernel": lambda: dm.dequant_merge_flat(acc, q, g, scales,
                                                    offsets, n_old, n_k),
            "plain": lambda: ref.dequant_merge_flat_ref(
                acc, q, g, scales, offsets, n_old, n_k)}
    best = _best_of(runs, (("kernel", "plain"), ("plain", "kernel"),
                           ("kernel", "plain")))
    n = layout.n
    nbytes = 13 * n                  # acc, g f32 + q int8 read; out written
    bytes_ms = nbytes / mem_bw(device_name) * 1e3
    ops_ms = 6 * n / F32_FLOPS * 1e3  # dequant mul+add; 2 mul, add, div
    out = {"ms": best["kernel"], "plain_ms": best["plain"],
           "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "shape": [n], "leaves": len(layout.names), "bytes": nbytes,
           "mem_bw_assumed": mem_bw(device_name)}
    out["achieved_gbs"] = nbytes / (best["kernel"] * 1e-3) / 1e9
    out["roofline_share"] = out["bound_ms"] / best["kernel"]
    emit({"phase": "timing", "kernel": "dequant_merge", **out})
    return out


def _max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def _close(torch, got, want, atol: float, rtol: float) -> bool:
    """numpy's allclose rule, |got - want| <= atol + rtol * |want|."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


def _tol(torch, dtype) -> dict:
    """tests/test_kernels.py's tolerances: 2e-5 in f32, 2e-2 in bf16."""
    return dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 \
        else dict(atol=2e-5, rtol=2e-5)


# K4 at the serve path's own widths (qwen3-0.6b heads, s 2048 or 1000) in
# bf16.  There a causal output element is only ~0.03-0.05 in the later rows,
# so the sweep's 2e-2 would let a wrong kernel through.  Two sound
# implementations differ by at most one bf16 rounding of each output (f32
# sums that agree to ~1e-6 cross at most one rounding boundary): at most
# 2^-7 * |x| <= rtol * |x|.  The atol is twice one rounding below |x| = 1
# (2^-8), for outputs near zero.
SERVE_ATTN_BF16_TOL = dict(atol=8e-3, rtol=8e-3)


def _serve_cfg(impl: str = "pallas"):
    from dataclasses import replace
    from repro_torch.configs import get_arch
    return replace(get_arch(SERVE_ARCH), attn_impl=impl)


def _serve_shapes():
    """K3's rows at the serve path: the block norms [b*s, d_model] and the
    q-norm [b*s*n_heads, head_dim]; K4's q and k/v."""
    cfg = _serve_cfg()
    rows = SERVE_BATCH * SERVE_PROMPT
    hd = cfg.resolved_head_dim
    return {"norm_block": (rows, cfg.d_model),
            "norm_q": (rows * cfg.n_heads, hd),
            "q": (SERVE_BATCH, SERVE_PROMPT, cfg.n_heads, hd),
            "kv": (SERVE_BATCH, SERVE_PROMPT, cfg.n_kv_heads, hd)}


def phase_check_k3(torch) -> dict:
    """K3 against its plain version over the reference's sweep in f32 and
    bf16, and at the serve path's two norm shapes in bf16."""
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    shapes = _serve_shapes()
    cases = [(shape, dt) for dt in (torch.float32, torch.bfloat16)
             for shape in RMS_SWEEP]
    cases += [(shapes["norm_block"], torch.bfloat16),
              (shapes["norm_q"], torch.bfloat16)]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for shape, dt in cases:
        x = torch.randn(shape, generator=gen).to(dt).to(dev)
        scale = torch.randn(shape[-1:], generator=gen).to(dev)
        got = ops.rmsnorm(x, scale)
        want = ref.rmsnorm_ref(x, scale)
        torch.cuda.synchronize()
        err = _max_err(torch, got, want)
        key = str(dt).split(".")[-1]
        errs[key] = max(errs[key], err)
        check(got.dtype == dt and got.shape == x.shape,
              f"K3 {shape} {dt}: got {got.dtype} {tuple(got.shape)}")
        check(_close(torch, got, want, **_tol(torch, dt)),
              f"K3 {shape} {dt}: max err {err}")
    emit({"phase": "check", "kernel": "rmsnorm", "cases": len(cases),
          "tolerance": {"float32": 2e-5, "bfloat16": 2e-2},
          "max_abs_err": errs})
    return errs


def _fused_qkv(torch, b, s, hq, hkv, d, dt, gen, dev):
    """q, k and v as strided views of one ``[b, s, hq + 2 hkv, d]`` buffer
    (a fused projection's output), nothing copied."""
    qkv = torch.randn(b, s, hq + 2 * hkv, d, generator=gen).to(dt).to(dev)
    return qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]


def phase_check_k4(torch) -> dict:
    """K4 against its plain version: the reference's sweep (causal) in f32
    and bf16, the qwen3, granite-moe and internvl2 serve shapes in f32 and
    bf16, one
    ragged causal prompt in bf16, non-causal cases, causal queries longer than their keys (the
    zero keys of the reference's padding), and the wgmma route's bf16 cases
    (d 64 and 128, GQA groups 1, 2, 4 and 8, q/k/v as views of one fused
    buffer).  Every case must take the route its dtype and head dim name,
    and a bf16 input TMA cannot address must raise without a launch."""
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    cfg = _serve_cfg()
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    bf16 = torch.bfloat16
    # (shape (b, s, hq, hkv, d), t, causal, dtype, fused q/k/v views)
    cases = [((b, s, hq_, hkv_, d), s, True, dt, False)
             for dt in (torch.float32, bf16)
             for b, s, hq_, hkv_, d in ATTN_SWEEP]
    serve = (SERVE_BATCH, SERVE_PROMPT, hq, hkv, hd)
    ragged = (1, RAGGED_PROMPT, hq, hkv, hd)
    moe = _moe_cfg()
    serve_moe = (SERVE_BATCH, SERVE_PROMPT, moe.n_heads, moe.n_kv_heads,
                 moe.resolved_head_dim)
    vlm = _vlm_cfg()
    serve_vlm = (SERVE_BATCH, _vlm_positions(vlm), vlm.n_heads,
                 vlm.n_kv_heads, vlm.resolved_head_dim)
    cases += [(serve, SERVE_PROMPT, True, torch.float32, False),
              (serve, SERVE_PROMPT, True, bf16, False),
              (ragged, RAGGED_PROMPT, True, bf16, False),
              # granite-moe's serve shape: head dim 64, GQA group 3
              (serve_moe, SERVE_PROMPT, True, torch.float32, False),
              (serve_moe, SERVE_PROMPT, True, bf16, False),
              # internvl2's: 2,304 positions (9 kv blocks of 256), group 6
              (serve_vlm, serve_vlm[1], True, torch.float32, False),
              (serve_vlm, serve_vlm[1], True, bf16, False),
              ((2, 256, 4, 2, 64), 256, False, torch.float32, False),
              ((1, 300, 4, 2, 64), 200, True, torch.float32, False),
              # the wgmma route: ragged with t < s, GQA groups 1 and 8,
              # non-causal, d 64 and 128, fused views
              ((1, 300, 4, 2, 64), 200, True, bf16, False),
              ((1, 300, 4, 2, 128), 200, True, bf16, False),
              ((1, 260, 4, 4, 128), 260, True, bf16, False),
              ((1, 384, 8, 1, 128), 384, True, bf16, False),
              ((2, 256, 4, 2, 64), 256, False, bf16, False),
              ((1, 256, 8, 2, 128), 256, False, bf16, False),
              ((2, 300, 16, 8, 128), 300, True, bf16, True),
              ((2, 200, 6, 2, 64), 200, True, bf16, True)]
    errs = {"float32": 0.0, "bfloat16": 0.0, "bfloat16_serve_shapes": 0.0}
    routes = {"simt": 0, "wgmma": 0}
    for (b, s, hq_, hkv_, d), t, causal, dt, fused in cases:
        key = str(dt).split(".")[-1]
        tol = _tol(torch, dt)
        if dt == bf16 and (b, s, hq_, hkv_, d) in (serve, ragged,
                                                   serve_moe, serve_vlm):
            key, tol = "bfloat16_serve_shapes", SERVE_ATTN_BF16_TOL
        if fused:
            q, k, v = _fused_qkv(torch, b, s, hq_, hkv_, d, dt, gen, dev)
        else:
            q = torch.randn(b, s, hq_, d, generator=gen).to(dt).to(dev)
            k = torch.randn(b, t, hkv_, d, generator=gen).to(dt).to(dev)
            v = torch.randn(b, t, hkv_, d, generator=gen).to(dt).to(dev)
        path = fl.route(dt, d)
        before = dict(fl.ROUTE_LAUNCHES)
        got = ops.flash_attention(q, k, v, causal=causal)
        check(fl.ROUTE_LAUNCHES[path] == before[path] + 1,
              f"K4 {(b, s, t, hq_, hkv_, d)} {dt} did not launch the "
              f"{path} kernel")
        routes[path] += 1
        want = ref.flash_attention_bshd_ref(q, k, v, causal=causal,
                                            t_pad=ops.padded_kv_len(t))
        torch.cuda.synchronize()
        err = _max_err(torch, got, want)
        errs[key] = max(errs[key], err)
        check(got.dtype == dt and got.shape == q.shape,
              f"K4 {(b, s, t, hq_, hkv_, d)}: got {got.dtype} "
              f"{tuple(got.shape)}")
        check(_close(torch, got, want, **tol),
              f"K4 {(b, s, t, hq_, hkv_, d)} causal={causal} {dt}: max err "
              f"{err} over {tol}")
    # A head stride of 129 elements (258 bytes) is no TMA stride.
    odd = torch.randn(1, 128, 2, 129, generator=gen).to(bf16).to(dev)
    odd = odd[..., :128]
    before = fl.LAUNCHES
    try:
        ops.flash_attention(odd, odd[:, :, :1], odd[:, :, :1], causal=True)
        raised = False
    except ValueError:
        raised = True
    check(raised and fl.LAUNCHES == before,
          "a bf16 input with a misaligned stride did not raise")
    emit({"phase": "check", "kernel": "flash_attention", "cases": len(cases),
          "routes": routes,
          "tolerance": {"float32": 2e-5, "bfloat16": 2e-2,
                        "bfloat16_serve_shapes": SERVE_ATTN_BF16_TOL},
          "max_abs_err": errs, "misaligned_bf16_raises": raised})
    return errs


def phase_timing_k3(torch, device_name: str) -> dict:
    """K3, its plain version and F.rms_norm at the serve path's shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(8)
    out = {}
    for label, shape in (("norm_block", _serve_shapes()["norm_block"]),
                         ("norm_q", _serve_shapes()["norm_q"])):
        x = torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
        scale = torch.randn(shape[-1:], generator=gen).to(dev)
        # The library call takes its weight in x's dtype.
        scale_lib = scale.to(torch.bfloat16)
        runs = {"kernel": lambda: rn.rmsnorm_rows(x, scale, 1e-6),
                "plain": lambda: ref.rmsnorm_ref(x, scale),
                "library": lambda: F.rms_norm(x, shape[-1:], scale_lib,
                                              1e-6)}
        best = _best_of(runs, (("kernel", "plain", "library"),
                               ("library", "plain", "kernel"),
                               ("kernel", "plain", "library")))
        rows, d = shape
        nbytes = 2 * rows * d * x.element_size() + d * 4
        bytes_ms = nbytes / mem_bw(device_name) * 1e3
        ops_ms = 4 * rows * d / F32_FLOPS * 1e3   # square, add, 2 muls
        out[label] = {"ms": best["kernel"], "plain_ms": best["plain"],
                      "library_ms": best["library"],
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms
                      else "operations",
                      "shape": list(shape), "dtype": "bfloat16",
                      "bytes": nbytes}
        out[label]["roofline_share"] = out[label]["bound_ms"] / best["kernel"]
    emit({"phase": "timing", "kernel": "rmsnorm", **out})
    return out


def phase_timing_k4(torch, device_name: str, cfg=None,
                    s: int = SERVE_PROMPT) -> dict:
    """K4, its plain version and one F.scaled_dot_product_attention call
    at a serve shape (causal, GQA, bf16): 4 x ``s`` positions at the heads
    of ``cfg`` (default: the qwen3 serve path's 2,048)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(9)
    cfg = cfg or _serve_cfg()
    hd = cfg.resolved_head_dim
    q_shape = (SERVE_BATCH, s, cfg.n_heads, hd)
    kv_shape = (SERVE_BATCH, s, cfg.n_kv_heads, hd)
    q = torch.randn(q_shape, generator=gen).to(torch.bfloat16).to(dev)
    k = torch.randn(kv_shape, generator=gen).to(torch.bfloat16).to(dev)
    v = torch.randn(kv_shape, generator=gen).to(torch.bfloat16).to(dev)

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    runs = {"kernel": lambda: fl.flash_attention_bshd(q, k, v, causal=True,
                                                      t_pad=s),
            "plain": lambda: ref.flash_attention_bshd_ref(q, k, v,
                                                          causal=True),
            "library": library}
    orders = (("kernel", "plain", "library"), ("library", "plain", "kernel"),
              ("kernel", "plain", "library"))
    library_error = None
    try:                                   # a yardstick only, never the port
        got = library().transpose(1, 2)
        err = _max_err(torch, got, runs["kernel"]())
        torch.cuda.synchronize()
    except RuntimeError as e:
        runs["library"], library_error, err = None, str(e)[:200], None
    # set_deterministic() keeps SDPA off its fastest backend: the yardstick
    # is SDPA as fast as it runs, so time it with deterministic algorithms
    # off, and also as this script's settings leave it.
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        best = _best_of(runs, orders, iters=5, warmup=1)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    best_det = _best_of({"library": runs["library"]}, (("library",),),
                        iters=5, warmup=1)
    b, _, hq, d = q.shape
    flops = 4 * b * hq * (s * (s + 1) // 2) * d   # causal QK^T and PV
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    ops_ms = flops / BF16_FLOPS * 1e3
    bytes_ms = nbytes / mem_bw(device_name) * 1e3
    out = {"ms": best["kernel"], "plain_ms": best["plain"],
           "library_ms": best["library"], "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "shape_q": list(q.shape), "shape_kv": list(k.shape),
           "dtype": "bfloat16", "flops": flops, "bytes": nbytes,
           "arch": cfg.name,
           "library_ms_deterministic": best_det["library"],
           "library_vs_kernel_max_abs_diff": err,
           "library_error": library_error}
    out["roofline_share"] = out["bound_ms"] / best["kernel"]
    out["achieved_tflops"] = flops / (best["kernel"] * 1e-3) / 1e12
    emit({"phase": "timing", "kernel": "flash_attention", **out})
    return out


def _ssd_inputs(torch, shape, dtype, gen, *, model_like: bool):
    """K5's inputs in the model layout on the card.  The sweep's draws
    (tests/test_kernels.py: dt = softplus(normal), A_log and D scaled by
    0.3 and 0.1, B and C by 0.5), or, ``model_like``, the mixer's: dt =
    softplus(normal/2 + the init's dt_bias row), A_log = log(linspace(1, 16,
    h)), D = 1, x/B/C of SiLU-sized magnitude."""
    import torch.nn.functional as F
    b, s, h, p, g, n, _ = shape
    x = torch.randn(b, s, h, p, generator=gen)
    B = torch.randn(b, s, g, n, generator=gen) * 0.5
    C = torch.randn(b, s, g, n, generator=gen) * 0.5
    if model_like:
        x = x * 0.5
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt_bias = torch.log(torch.expm1(torch.exp(torch.linspace(lo, hi,
                                                                 h))))
        dt = F.softplus(torch.randn(b, s, h, generator=gen) * 0.5 + dt_bias)
        A_log = torch.log(torch.linspace(1.0, 16.0, h))
        D = torch.ones(h)
    else:
        dt = F.softplus(torch.randn(b, s, h, generator=gen))
        A_log = torch.randn(h, generator=gen) * 0.3
        D = torch.randn(h, generator=gen) * 0.1
    dev = torch.device("cuda")
    return (x.to(dtype).to(dev), dt.to(dev), A_log.to(dev),
            B.to(dtype).to(dev), C.to(dtype).to(dev), D.to(dev))


def phase_check_k5(torch) -> dict:
    """K5 against its plain version, y and the final state: the reference's
    sweep in f32 and bf16, the serve shape in f32 and bf16, a ragged
    1,000-row prompt in bf16, and the wgmma route's cases in bf16
    (``SSD_TOL``).  Every case must take the route its dtype and widths
    name."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd as k5
    gen = torch.Generator().manual_seed(12)
    cases = [(shape, dt, False) for dt in (torch.float32, torch.bfloat16)
             for shape in SSD_SWEEP]
    cases += [(SSD_SERVE, torch.float32, True),
              (SSD_SERVE, torch.bfloat16, True),
              (SSD_RAGGED, torch.bfloat16, True)]
    cases += [(shape, torch.bfloat16, True) for shape in SSD_WGMMA]
    errs = {"float32": 0.0, "bfloat16": 0.0, "state": 0.0}
    magnitude = {"float32": 0.0, "bfloat16": 0.0, "state": 0.0}
    routes = {"simt": 0, "wgmma": 0}
    case_routes = []
    for shape, dt, model_like in cases:
        key = str(dt).split(".")[-1]
        args = _ssd_inputs(torch, shape, dt, gen, model_like=model_like)
        s, ck = shape[1], shape[6]
        path = k5.route(dt, shape[3], shape[5], ck)
        before = k5.LAUNCHES
        before_route = dict(k5.ROUTE_LAUNCHES)
        y, state = ops.ssd(*args, chunk=ck, return_state=True)
        check(k5.LAUNCHES == before + 1, "K5 did not launch")
        check(k5.ROUTE_LAUNCHES[path] == before_route[path] + 1,
              f"K5 {shape} {dt}: did not take the {path} route")
        routes[path] += 1
        case_routes.append([list(shape), key, path])
        want_y, want_state = ref.ssd_chunks_ref(*args,
                                                chunk=ops.ssd_chunk(s, ck))
        torch.cuda.synchronize()
        check(y.dtype == dt and y.shape == args[0].shape
              and state.shape == want_state.shape,
              f"K5 {shape} {dt}: got {y.dtype} {tuple(y.shape)}")
        for k, got, want, tol in ((key, y, want_y, SSD_TOL[key]),
                                  ("state", state, want_state,
                                   SSD_TOL["float32"])):
            err = _max_err(torch, got, want)
            errs[k] = max(errs[k], err)
            magnitude[k] = max(magnitude[k], float(want.float().abs().max()))
            check(_close(torch, got, want, **tol),
                  f"K5 {shape} {dt} {k}: max err {err} over {tol}")
    emit({"phase": "check", "kernel": "ssd", "cases": len(cases),
          "tolerance": SSD_TOL, "max_abs_err": errs,
          "ref_max_abs": magnitude, "routes": routes,
          "case_routes": case_routes})
    return errs


def _ssd_work(args, chunk: int) -> tuple[int, int]:
    """(bytes, operations) the chunked SSD needs on these inputs: each input
    read once, y and the f32 final state written once; C B^T once per group
    and chunk (its lower triangle), the masked intra-chunk product, C .
    state for every chunk after the first, and the state update."""
    x, B = args[0], args[3]
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + x.numel() * x.element_size() + b * h * p * n * 4)
    q = min(chunk, (s + 7) // 8 * 8)
    rows = [min(q, s - t0) for t0 in range(0, s, q)]
    tri = sum(r * (r + 1) // 2 for r in rows)
    flops = (2 * b * g * tri * n                    # C B^T
             + 2 * b * h * tri * p                  # (C B^T * L)(x dt)
             + 2 * b * h * (s - rows[0]) * n * p    # C . state
             + 2 * b * h * s * p * n)               # the state update
    return nbytes, flops


def phase_timing_k5(torch, device_name: str) -> dict:
    """K5 and its plain version at the serve shape (bf16, the state
    returned, as prefill calls it).  No single PyTorch call computes the
    SSD, so there is no library time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as k5
    gen = torch.Generator().manual_seed(13)
    args = _ssd_inputs(torch, SSD_SERVE, torch.bfloat16, gen,
                       model_like=True)
    ck = SSD_SERVE[6]
    runs = {"kernel": lambda: k5.ssd_bshp(*args, chunk=ck, want_state=True),
            "plain": lambda: ref.ssd_chunks_ref(*args, chunk=ck)}
    best = _best_of(runs, (("kernel", "plain"), ("plain", "kernel"),
                           ("kernel", "plain")), iters=5, warmup=1)
    nbytes, flops = _ssd_work(args, ck)
    bytes_ms = nbytes / mem_bw(device_name) * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    out = {"ms": best["kernel"], "plain_ms": best["plain"],
           "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "shape": list(SSD_SERVE), "dtype": "bfloat16", "bytes": nbytes,
           "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms}
    out["roofline_share"] = out["bound_ms"] / best["kernel"]
    out["achieved_tflops"] = flops / (best["kernel"] * 1e-3) / 1e12
    emit({"phase": "timing", "kernel": "ssd", **out})
    return out


def _vocab(logits, cfg):
    return logits[..., :cfg.vocab_size]


def _compare(torch, a, b, tol: dict) -> dict:
    """Max |a - b|, the allclose verdict at ``tol`` and the greedy (argmax)
    agreement of two logit tensors."""
    return {"max_abs_diff": _max_err(torch, a, b),
            "ref_max_abs": float(b.float().abs().max()),
            "close": _close(torch, a, b, **tol),
            "argmax_agree": float((a.argmax(-1) == b.argmax(-1))
                                  .float().mean())}


def _serve_norms(torch, params, tokens, cfg) -> dict:
    """K3 through ``layers.rms_norm(impl="pallas")`` on the serve path's own
    norm inputs: layer 0's attention norm of the embedded prompt ([8192,
    1024]) and its q- and k-norms ([131072, 128], [65536, 128]); each
    against the model's default ``impl="xla"`` (bf16 tolerance 2e-2)."""
    from repro_torch.models.layers import rms_norm
    p = {name: leaf[0] for name, leaf in params["stack"]["p0"].items()}
    x = params["embed"][tokens]
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    h = rms_norm(x, p["attn_norm"], eps=cfg.norm_eps)
    inputs = {"attn_norm": x,
              "q_norm": (h @ p["wq"]).reshape(b, s, cfg.n_heads, hd),
              "k_norm": (h @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)}
    out = {}
    for name, t in inputs.items():
        got = rms_norm(t, p[name], eps=cfg.norm_eps, impl="pallas")
        want = rms_norm(t, p[name], eps=cfg.norm_eps)
        torch.cuda.synchronize()
        check(_close(torch, got, want, atol=2e-2, rtol=2e-2),
              f"K3 on the serve path's {name}: {_max_err(torch, got, want)}")
        out[name] = {"rows": got.numel() // got.shape[-1],
                     "max_abs_err": _max_err(torch, got, want)}
    return out


def _sync_s(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _greedy_decode(torch, params, cache, logits, start: int, cfg):
    """``SERVE_DECODE`` greedy decode steps from ``logits`` at positions
    ``start``, ``start + 1``, ...: (the generated tokens, the logits of
    the prefill and of every step, each step's synced wall seconds)."""
    from repro_torch.models import lm
    generated, step_logits, step_s = [], [logits], []
    for i in range(SERVE_DECODE):
        nxt = step_logits[-1].argmax(-1, keepdim=True)
        generated.append(nxt)
        (lg, cache), dt = _sync_s(
            torch, lambda: lm.decode_step(params, cache, nxt, start + i, cfg))
        step_logits.append(lg)
        step_s.append(dt)
    return generated, step_logits, step_s


def _check_logits(torch, step_logits, cfg) -> None:
    for i, lg in enumerate(step_logits):
        check(bool(torch.isfinite(_vocab(lg, cfg)).all()),
              f"{cfg.name}: non-finite logits at step {i}")
        check(bool((lg[:, cfg.vocab_size:] == -1e30).all()),
              f"{cfg.name}: vocab pad not masked at step {i}")


def phase_serve(torch) -> dict:
    """The serve path: qwen3-0.6b at its published widths and depth, bf16,
    ``attn_impl="pallas"``: one prefill of 4 x 2,048 tokens, 16 greedy
    decode steps, with the launch counts zeroed just before and read just
    after; then its checks against other routes through the model."""
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    dev = torch.device("cuda")
    cfg = _serve_cfg()
    params, init_s = _sync_s(torch, lambda: lm.init_params(0, cfg))
    n_params = lm.param_count(params)
    check(n_params == SERVE_PARAMS, f"{SERVE_ARCH}: {n_params} params")
    gen = torch.Generator().manual_seed(10)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen).to(dev)
    lm.prefill(params, {"tokens": tokens[:, :128]}, cfg, max_len=144)  # warm
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    (logits, cache), prefill_s = _sync_s(
        torch, lambda: lm.prefill(params, {"tokens": tokens}, cfg,
                                  max_len=SERVE_MAX_LEN))
    after_prefill = ops.launch_counts()
    routes_prefill = dict(fl.ROUTE_LAUNCHES)
    prefill_peak = torch.cuda.max_memory_allocated()
    generated, step_logits, step_s = _greedy_decode(
        torch, params, cache, logits, SERVE_PROMPT, cfg)
    after_decode = ops.launch_counts()
    routes_decode = {k: n - routes_prefill[k]
                     for k, n in fl.ROUTE_LAUNCHES.items()}
    norms = _serve_norms(torch, params, tokens, cfg)
    launches = ops.launch_counts()

    check(after_prefill["flash_attention"] == cfg.n_layers,
          f"K4 launched {after_prefill['flash_attention']} times in a "
          f"prefill of {cfg.n_layers} layers")
    check(after_decode["flash_attention"] == cfg.n_layers,
          f"K4 launched in decode: {after_decode}")
    check(routes_prefill == {"simt": 0, "wgmma": cfg.n_layers},
          f"K4's prefill launches by route: {routes_prefill}")
    check(routes_decode == {"simt": 0, "wgmma": 0},
          f"K4's decode launches by route: {routes_decode}")
    check(launches["rmsnorm"] == len(norms), f"K3 launches {launches}")
    _check_logits(torch, step_logits, cfg)
    emit({"phase": "serve", "arch": SERVE_ARCH, "attn_impl": "pallas",
          "dtype": cfg.dtype, "n_layers": cfg.n_layers,
          "n_params": n_params, "batch": SERVE_BATCH,
          "prompt": SERVE_PROMPT, "decode_steps": SERVE_DECODE,
          "init_params_s": init_s, "prefill_ms": prefill_s * 1e3,
          "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_s,
          "decode_ms_per_step": sum(step_s) / len(step_s) * 1e3,
          "decode_ms_steps": [x * 1e3 for x in step_s],
          "decode_tokens_per_s": SERVE_BATCH * len(step_s) / sum(step_s),
          "prefill_peak_bytes": prefill_peak,
          "launches_prefill": after_prefill,
          "k4_routes_prefill": routes_prefill,
          "k4_routes_decode": routes_decode,
          "launches_decode": {k: after_decode[k] - after_prefill[k]
                              for k in after_decode},
          "launches_norm_pass": {k: launches[k] - after_decode[k]
                                 for k in launches},
          "k3_serve_norms": norms})

    # The same prefill through dense attention.
    dense_logits, _ = lm.prefill(params, {"tokens": tokens}, _serve_cfg(
        "dense"), max_len=SERVE_MAX_LEN)
    vs_dense = _compare(torch, _vocab(logits, cfg), _vocab(dense_logits, cfg),
                        SERVE_TOL)
    del dense_logits
    # Prefill + decode against the teacher-forced forward over the prompt
    # and the 16 generated tokens.
    seq = torch.cat([tokens] + generated, dim=1)
    full = lm.forward(params, {"tokens": seq}, cfg)
    served = torch.stack([_vocab(lg, cfg) for lg in step_logits], dim=1)
    vs_forward = _compare(torch, served,
                          full[:, SERVE_PROMPT - 1:SERVE_PROMPT + SERVE_DECODE],
                          SERVE_TOL)
    del full
    # A ragged prompt: 1,000 is not a multiple of the reference's kv block.
    ops.reset_launch_counts()
    ragged, _ = lm.prefill(params, {"tokens": tokens[:, :RAGGED_PROMPT]}, cfg)
    ragged_k4 = ops.launch_counts()["flash_attention"]
    ragged_dense, _ = lm.prefill(params, {"tokens": tokens[:, :RAGGED_PROMPT]},
                                 _serve_cfg("dense"))
    vs_ragged = _compare(torch, _vocab(ragged, cfg), _vocab(ragged_dense, cfg),
                         SERVE_TOL)
    check(ragged_k4 == cfg.n_layers, f"ragged prefill: K4 {ragged_k4}")
    emit({"phase": "serve_checks", "tolerance": SERVE_TOL,
          "pallas_vs_dense_prefill": vs_dense,
          "prefill_decode_vs_forward": vs_forward,
          "ragged_s": RAGGED_PROMPT, "ragged_pallas_vs_dense": vs_ragged,
          "ragged_k4_launches": ragged_k4})
    check(vs_dense["close"], f"pallas vs dense prefill: {vs_dense}")
    check(vs_forward["close"], f"prefill + decode vs forward: {vs_forward}")
    check(vs_ragged["close"], f"ragged prefill pallas vs dense: {vs_ragged}")
    return {"params": params, "tokens": tokens, "launches": launches,
            "k4_routes_prefill": routes_prefill,
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": sum(step_s) / len(step_s) * 1e3}


def _ssm_cfg(impl: str = "pallas"):
    from dataclasses import replace
    from repro_torch.configs import get_arch
    return replace(get_arch(SSM_ARCH), ssd_impl=impl)


def _moe_cfg(dtype: str = "bfloat16"):
    from dataclasses import replace
    from repro_torch.configs import get_arch
    return replace(get_arch(MOE_ARCH), attn_impl="pallas",
                   moe_impl="scatter", dtype=dtype)


def _audio_cfg(impl: str = "dense"):
    from dataclasses import replace
    from repro_torch.configs import get_arch
    return replace(get_arch(AUDIO_ARCH), attn_impl=impl)


def _vlm_cfg(impl: str = "pallas"):
    from dataclasses import replace
    from repro_torch.configs import get_arch
    return replace(get_arch(VLM_ARCH), n_layers=VLM_LAYERS, attn_impl=impl)


def _vlm_positions(cfg) -> int:
    """The VLM prompt's hidden length: its patches, then its tokens."""
    return cfg.frontend_len + SERVE_PROMPT


def _stub_inputs(torch, cfg, b: int, gen) -> dict:
    """The modality stub of ``cfg`` for ``b`` requests, standard normal
    from ``gen`` on the CPU: patch embeddings ``[b, frontend_len,
    frontend_dim]`` or audio frames ``[b, frontend_len, d_model]``; {}
    without a frontend."""
    if cfg.frontend == "patch":
        return {"patch_embed": torch.randn(
            b, cfg.frontend_len, cfg.resolved_frontend_dim, generator=gen)}
    if cfg.frontend == "audio":
        return {"frames": torch.randn(b, cfg.frontend_len, cfg.d_model,
                                      generator=gen)}
    return {}


def _ssm_state(cache):
    return cache["p0"]["ssm"]


def _ssm_route_checks(torch, params, cfg, tokens, generated, main,
                      tol) -> dict:
    """The SSM serve path's routes against each other at ``tol``: the K5
    prefill against the chunked one (logits and the SSM state of every
    layer), prefill + decode (teacher-forced with ``generated``) against
    ``forward``, and a 1,000-token prompt through both SSDs.  ``main`` is
    the already served ``(prefill logits, SSM state, step logits)``, or
    None to serve them here.  The two prefills' logits are returned under
    ``pallas_logits`` and ``chunked_logits``."""
    from dataclasses import replace
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    if main is None:
        logits, cache = lm.prefill(params, {"tokens": tokens}, cfg,
                                   max_len=SERVE_MAX_LEN)
        state, steps = _ssm_state(cache).clone(), [logits]
        for i, nxt in enumerate(generated):
            lg, cache = lm.decode_step(params, cache, nxt, SERVE_PROMPT + i,
                                       cfg)
            steps.append(lg)
        del cache
    else:
        logits, state, steps = main
    chunked = replace(cfg, ssd_impl="chunked")
    c_logits, c_cache = lm.prefill(params, {"tokens": tokens}, chunked,
                                   max_len=SERVE_MAX_LEN)
    out = {"pallas_vs_chunked_prefill": _compare(
               torch, _vocab(logits, cfg), _vocab(c_logits, cfg), tol),
           "ssm_state_pallas_vs_chunked": {
               k: v for k, v in _compare(torch, state, _ssm_state(c_cache),
                                         tol).items() if k != "argmax_agree"},
           "pallas_logits": _vocab(logits, cfg),
           "chunked_logits": _vocab(c_logits, cfg)}
    del c_cache
    seq = torch.cat([tokens] + generated, dim=1)
    full = lm.forward(params, {"tokens": seq}, cfg)
    served = torch.stack([_vocab(lg, cfg) for lg in steps], dim=1)
    out["prefill_decode_vs_forward"] = _compare(
        torch, served, full[:, SERVE_PROMPT - 1:SERVE_PROMPT + SERVE_DECODE],
        tol)
    del full
    # A ragged prompt: 1,000 rows are no multiple of the chunk (128).
    ops.reset_launch_counts()
    ragged, _ = lm.prefill(params, {"tokens": tokens[:, :RAGGED_PROMPT]}, cfg)
    out["ragged_k5_launches"] = ops.launch_counts()["ssd"]
    ragged_c, _ = lm.prefill(params, {"tokens": tokens[:, :RAGGED_PROMPT]},
                             chunked)
    out["ragged_s"] = RAGGED_PROMPT
    out["ragged_pallas_vs_chunked"] = _compare(
        torch, _vocab(ragged, cfg), _vocab(ragged_c, cfg), tol)
    return out


def phase_serve_ssm(torch) -> dict:
    """The SSM serve path: mamba2-2.7b at its published widths and depth,
    bf16, ``ssd_impl="pallas"``, weights from ``init_params(0)``: one
    prefill of 4 x 2,048 tokens (K5 exactly once per layer) and 16 greedy
    decode steps (no K5), with the launch counts zeroed just before and read
    just after; finite logits; then the pallas prefill against the chunked
    one (logits and every layer's SSM state), prefill + decode against a
    teacher-forced ``forward`` and a 1,000-token prompt, in bf16
    (``SSM_BF16_TOL``) and with the same weights in f32 (``SSM_F32_TOL``);
    each bf16 prefill's distance from the f32 one is reported."""
    from dataclasses import replace
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd as k5
    from repro_torch.models import lm
    dev = torch.device("cuda")
    cfg = _ssm_cfg()
    params, init_s = _sync_s(torch, lambda: lm.init_params(0, cfg))
    n_params = lm.param_count(params)
    check(n_params == SSM_PARAMS, f"{SSM_ARCH}: {n_params} params")
    gen = torch.Generator().manual_seed(14)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen).to(dev)
    lm.prefill(params, {"tokens": tokens[:, :128]}, cfg, max_len=144)  # warm
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    (logits, cache), prefill_s = _sync_s(
        torch, lambda: lm.prefill(params, {"tokens": tokens}, cfg,
                                  max_len=SERVE_MAX_LEN))
    after_prefill = ops.launch_counts()
    routes_prefill = dict(k5.ROUTE_LAUNCHES)
    prefill_peak = torch.cuda.max_memory_allocated()
    prefill_state = _ssm_state(cache).clone()
    generated, step_logits, step_s = _greedy_decode(
        torch, params, cache, logits, SERVE_PROMPT, cfg)
    launches = ops.launch_counts()
    routes_decode = {k: n - routes_prefill[k]
                     for k, n in k5.ROUTE_LAUNCHES.items()}
    check(routes_prefill == {"simt": 0, "wgmma": cfg.n_layers},
          f"K5's prefill launches by route: {routes_prefill}")
    check(routes_decode == {"simt": 0, "wgmma": 0},
          f"K5's decode launches by route: {routes_decode}")
    check(after_prefill["ssd"] == cfg.n_layers,
          f"K5 launched {after_prefill['ssd']} times in a prefill of "
          f"{cfg.n_layers} layers")
    check(launches["ssd"] == cfg.n_layers, f"K5 launched in decode: "
                                           f"{launches}")
    _check_logits(torch, step_logits, cfg)
    check(bool(torch.isfinite(_ssm_state(cache)).all()),
          "non-finite SSM state")
    emit({"phase": "serve_ssm", "arch": SSM_ARCH, "ssd_impl": "pallas",
          "dtype": cfg.dtype, "n_layers": cfg.n_layers,
          "n_params": n_params, "batch": SERVE_BATCH,
          "prompt": SERVE_PROMPT, "decode_steps": SERVE_DECODE,
          "init_params_s": init_s, "prefill_ms": prefill_s * 1e3,
          "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_s,
          "decode_ms_per_step": sum(step_s) / len(step_s) * 1e3,
          "decode_ms_steps": [x * 1e3 for x in step_s],
          "decode_tokens_per_s": SERVE_BATCH * len(step_s) / sum(step_s),
          "prefill_peak_bytes": prefill_peak,
          "launches_prefill": after_prefill,
          "launches_decode": {k: launches[k] - after_prefill[k]
                              for k in launches},
          "k5_routes_prefill": routes_prefill,
          "k5_routes_decode": routes_decode})
    main = (logits, prefill_state, step_logits)
    bf16 = _ssm_route_checks(torch, params, cfg, tokens, generated, main,
                             SSM_BF16_TOL)
    # The f32 yardstick: the same weights upcast, every route again.
    params32 = {"embed": params["embed"].float(),
                "final_norm": params["final_norm"],
                "stack": {k: {n: t.float() for n, t in v.items()}
                          for k, v in params["stack"].items()}}
    f32 = _ssm_route_checks(torch, params32, replace(cfg, dtype="float32"),
                            tokens, generated, None, SSM_F32_TOL)
    del params32
    bf16_vs_f32 = {route: _compare(torch, bf16.pop(f"{route}_logits"),
                                   f32.pop(f"{route}_logits"),
                                   SSM_BF16_TOL)
                   for route in ("pallas", "chunked")}
    emit({"phase": "serve_ssm_checks", "tolerance": {
              "bfloat16": SSM_BF16_TOL, "float32": SSM_F32_TOL},
          "bfloat16": bf16, "float32": f32,
          "bf16_vs_f32_prefill": bf16_vs_f32})
    for name, res in (("bf16", bf16), ("f32", f32)):
        for key, val in res.items():
            if isinstance(val, dict):
                check(val["close"], f"SSM serve {name} {key}: {val}")
        check(res["ragged_k5_launches"] == cfg.n_layers,
              f"{name} ragged prefill: K5 {res['ragged_k5_launches']}")
    return {"params": params, "tokens": tokens, "launches": after_prefill,
            "k5_routes_prefill": routes_prefill,
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": sum(step_s) / len(step_s) * 1e3}


class _Routing:
    """While active, records the routing of every MoE dispatch by wrapping
    ``repro_torch.models.layers._moe_dispatch`` (which ``moe_layer_3d``
    calls): per call, each token's top-k experts as a sorted set, the gap
    between its k-th and (k+1)-th router probabilities, and the capacity.
    It recomputes the router (a GEMM, a softmax, a sort) beside the
    model's own, and changes nothing the model computes."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        from repro_torch.models import layers
        self._layers, inner = layers, layers._moe_dispatch
        self._inner = inner
        torch = self.torch

        def record(x, router_w, *args, top_k, capacity_factor=1.25, **kw):
            probs = torch.softmax((x @ router_w).float(), dim=-1)
            vals, idx = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
            T, E = probs.shape
            self.calls.append({
                "experts": idx[:, :top_k].sort(dim=-1).values,
                "gap": vals[:, top_k - 1] - vals[:, top_k],
                "capacity": max(1, int(capacity_factor * top_k * T / E)),
                "n_experts": E})
            return inner(x, router_w, *args, top_k=top_k,
                         capacity_factor=capacity_factor, **kw)

        layers._moe_dispatch = record
        return self

    def __exit__(self, *exc):
        self._layers._moe_dispatch = self._inner


def _dropped_slots(torch, calls) -> dict:
    """Slots over capacity, ``Σ_e max(0, n_e - C)``, over ``T·k`` slots: per
    MoE layer (one call each) and over all."""
    over = []
    for c in calls:
        n = torch.bincount(c["experts"].flatten(), minlength=c["n_experts"])
        over.append(int((n - c["capacity"]).clamp(min=0).sum()))
    slots = calls[0]["experts"].numel()
    return {"capacity": calls[0]["capacity"], "slots_per_layer": slots,
            "share_per_layer": [o / slots for o in over],
            "share": sum(over) / (slots * len(over))}


def _route_grid(torch, calls, n_moe: int, b: int) -> dict:
    """Per MoE layer, the routes of consecutive passes over ``b`` sequences
    (a prefill or forward, then any decode steps, ``n_moe`` calls each),
    laid side by side along the sequence: experts ``[L, b, S, k]``, gap
    ``[L, b, S]``."""
    passes = [calls[i:i + n_moe] for i in range(0, len(calls), n_moe)]
    return {key: torch.stack([
        torch.cat([p[layer][key].reshape(b, -1, *p[layer][key].shape[1:])
                   for p in passes], dim=1) for layer in range(n_moe)])
        for key in ("experts", "gap")}


def _route_compare(torch, calls_a, calls_b, n_moe: int, positions, a, b,
                   tol: dict, tie_gap: float) -> dict:
    """Logits ``a`` and ``b`` (``[batch, len(positions), vocab]``) of two
    routes, held at ``tol`` on the compared tokens whose routing gap is at
    least ``tie_gap`` at every MoE layer in both routes (0: all of them);
    with the count of (token, layer) routing decisions that differ."""
    ga = _route_grid(torch, calls_a, n_moe, a.shape[0])
    gb = _route_grid(torch, calls_b, n_moe, a.shape[0])
    differ = (ga["experts"] != gb["experts"]).any(-1)         # [L, b, S]
    near = (ga["gap"] < tie_gap) | (gb["gap"] < tie_gap)
    clear = ~near[:, :, positions].any(0)                      # [b, P]
    res = _compare(torch, a[clear], b[clear], tol)
    res.update({"compared_tokens": int(clear.sum()),
                "near_tie_tokens_skipped": int((~clear).sum()),
                "routing_decisions": differ.numel(),
                "routing_decisions_differ": int(differ.sum()),
                "compared_tokens_whose_routing_differs": int(
                    differ[:, :, positions].any(0).sum())})
    return res


def _moe_route_checks(torch, params, cfg, tokens, generated, tol,
                      tie_gap) -> dict:
    """The MoE serve path's routes against each other (``_route_compare``):
    the pallas prefill against the dense one at the served capacity
    factor; a dropless prefill + decode (teacher-forced with
    ``generated``) against a dropless ``forward``, as
    tests/test_archs.py:80 compares them; a 1,000-token prompt through
    both attentions.  Also the dropped-slot share of the pallas prefill,
    and the two prefills' logits (``pallas_logits``, ``dense_logits``)."""
    from dataclasses import replace
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    b, s = tokens.shape
    n_moe = cfg.n_layers               # every granite layer is an MoE layer
    dense = replace(cfg, attn_impl="dense")
    dropless = replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)

    def prefill(c, toks):
        with _Routing(torch) as r:
            logits, _ = lm.prefill(params, {"tokens": toks}, c)
        return _vocab(logits, cfg)[:, None], r.calls

    lp, rp = prefill(cfg, tokens)
    ld, rd = prefill(dense, tokens)
    out = {"pallas_vs_dense_prefill": _route_compare(
               torch, rp, rd, n_moe, [s - 1], lp, ld, tol, tie_gap),
           "dropped_slots_prefill": _dropped_slots(torch, rp),
           "pallas_logits": lp[:, 0], "dense_logits": ld[:, 0]}
    del rp, rd
    with _Routing(torch) as r:
        lg, cache = lm.prefill(params, {"tokens": tokens}, dropless,
                               max_len=SERVE_MAX_LEN)
        steps = [lg]
        for i, nxt in enumerate(generated):
            lg, cache = lm.decode_step(params, cache, nxt, s + i, dropless)
            steps.append(lg)
    del cache
    seq = torch.cat([tokens] + generated, dim=1)
    with _Routing(torch) as rf:
        full = lm.forward(params, {"tokens": seq}, dropless)
    served = torch.stack([_vocab(x, cfg) for x in steps], dim=1)
    positions = list(range(s - 1, s + len(generated)))
    out["prefill_decode_vs_forward"] = _route_compare(
        torch, r.calls, rf.calls, n_moe, positions, served,
        full[:, s - 1:], tol, tie_gap)
    out["dropless_capacity"] = {"prefill": r.calls[0]["capacity"],
                                "decode": r.calls[-1]["capacity"],
                                "forward": rf.calls[0]["capacity"]}
    del full, served, r, rf
    ops.reset_launch_counts()
    lr, rr = prefill(cfg, tokens[:, :RAGGED_PROMPT])
    out["ragged_k4_launches"] = ops.launch_counts()["flash_attention"]
    lrd, rrd = prefill(dense, tokens[:, :RAGGED_PROMPT])
    out["ragged_s"] = RAGGED_PROMPT
    out["ragged_pallas_vs_dense"] = _route_compare(
        torch, rr, rrd, n_moe, [RAGGED_PROMPT - 1], lr, lrd, tol, tie_gap)
    return out


def phase_serve_moe(torch) -> dict:
    """The MoE serve path: granite-moe-3b-a800m at its published widths and
    depth, bf16, ``attn_impl="pallas"``, ``moe_impl="scatter"``, weights
    from ``init_params(0)``: one prefill of 4 x 2,048 tokens (K4 exactly
    once per layer, all on its wgmma route) and 16 greedy decode steps (no
    K4), with the launch counts zeroed just before and read just after;
    finite logits; the prefill's dropped-slot share at capacity factor
    1.25; then the route checks (``_moe_route_checks``) in bf16
    (``MOE_BF16_TOL``) and with the same weights upcast to f32
    (``MOE_F32_TOL`` on tokens clear of near-ties); each bf16 prefill's
    distance from the f32 one is reported."""
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    dev = torch.device("cuda")
    cfg = _moe_cfg()
    params, init_s = _sync_s(torch, lambda: lm.init_params(0, cfg))
    n_params = lm.param_count(params)
    check(n_params == MOE_PARAMS, f"{MOE_ARCH}: {n_params} params")
    gen = torch.Generator().manual_seed(15)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen).to(dev)
    lm.prefill(params, {"tokens": tokens[:, :128]}, cfg, max_len=144)  # warm
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    (logits, cache), prefill_s = _sync_s(
        torch, lambda: lm.prefill(params, {"tokens": tokens}, cfg,
                                  max_len=SERVE_MAX_LEN))
    after_prefill = ops.launch_counts()
    routes_prefill = dict(fl.ROUTE_LAUNCHES)
    prefill_peak = torch.cuda.max_memory_allocated()
    generated, step_logits, step_s = _greedy_decode(
        torch, params, cache, logits, SERVE_PROMPT, cfg)
    launches = ops.launch_counts()
    routes_decode = {k: n - routes_prefill[k]
                     for k, n in fl.ROUTE_LAUNCHES.items()}
    del cache
    check(after_prefill["flash_attention"] == cfg.n_layers,
          f"K4 launched {after_prefill['flash_attention']} times in a "
          f"prefill of {cfg.n_layers} layers")
    check(launches["flash_attention"] == cfg.n_layers,
          f"K4 launched in decode: {launches}")
    check(routes_prefill == {"simt": 0, "wgmma": cfg.n_layers},
          f"K4's prefill launches by route: {routes_prefill}")
    check(routes_decode == {"simt": 0, "wgmma": 0},
          f"K4's decode launches by route: {routes_decode}")
    _check_logits(torch, step_logits, cfg)
    emit({"phase": "serve_moe", "arch": MOE_ARCH, "attn_impl": "pallas",
          "moe_impl": cfg.moe_impl, "dtype": cfg.dtype,
          "n_layers": cfg.n_layers, "n_params": n_params,
          "n_experts": cfg.n_experts, "top_k": cfg.top_k,
          "capacity_factor": cfg.capacity_factor, "batch": SERVE_BATCH,
          "prompt": SERVE_PROMPT, "decode_steps": SERVE_DECODE,
          "reduced": {"moe_impl": "scatter (the reference's knob; at T = "
                      "8,192 'einsum' would build a [8192, 8, 40, 2048] "
                      "one-hot, 10.7 GB in bf16, and ~16 PFLOP of "
                      "dispatch products a layer)"},
          "init_params_s": init_s, "prefill_ms": prefill_s * 1e3,
          "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_s,
          "decode_ms_per_step": sum(step_s) / len(step_s) * 1e3,
          "decode_ms_steps": [x * 1e3 for x in step_s],
          "decode_tokens_per_s": SERVE_BATCH * len(step_s) / sum(step_s),
          "prefill_peak_bytes": prefill_peak,
          "launches_prefill": after_prefill,
          "launches_decode": {k: launches[k] - after_prefill[k]
                              for k in launches},
          "k4_routes_prefill": routes_prefill,
          "k4_routes_decode": routes_decode})
    bf16 = _moe_route_checks(torch, params, cfg, tokens, generated,
                             MOE_BF16_TOL, 0.0)
    # The recorded pallas prefill is the served one, bit for bit.
    check(torch.equal(bf16["pallas_logits"], _vocab(logits, cfg)),
          "a second pallas prefill differs from the first")
    params32 = {"embed": params["embed"].float(),
                "final_norm": params["final_norm"],
                "stack": {k: {n: t.float() for n, t in v.items()}
                          for k, v in params["stack"].items()}}
    f32 = _moe_route_checks(torch, params32, _moe_cfg("float32"), tokens,
                            generated, MOE_F32_TOL, MOE_F32_TIE_GAP)
    del params32
    bf16_vs_f32 = {route: _compare(torch, bf16.pop(f"{route}_logits"),
                                   f32.pop(f"{route}_logits"),
                                   MOE_BF16_TOL)
                   for route in ("pallas", "dense")}
    emit({"phase": "serve_moe_checks", "tolerance": {
              "bfloat16": MOE_BF16_TOL, "float32": MOE_F32_TOL},
          "tie_gap": {"bfloat16": 0.0, "float32": MOE_F32_TIE_GAP},
          "bfloat16": bf16, "float32": f32,
          "bf16_vs_f32_prefill": bf16_vs_f32})
    for name, res in (("bf16", bf16), ("f32", f32)):
        for key, val in res.items():
            if isinstance(val, dict) and "close" in val:
                check(val["close"], f"MoE serve {name} {key}: {val}")
                check(val["compared_tokens"] > 0,
                      f"MoE serve {name} {key}: no token compared")
        check(res["ragged_k4_launches"] == cfg.n_layers,
              f"{name} ragged prefill: K4 {res['ragged_k4_launches']}")
    return {"params": params, "tokens": tokens, "launches": after_prefill,
            "k4_routes_prefill": routes_prefill,
            "dropped_share": bf16["dropped_slots_prefill"]["share"],
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": sum(step_s) / len(step_s) * 1e3}


def _serve_record(cfg, n_params, init_s, prefill_s, step_s, positions,
                  prefill_peak) -> dict:
    return {"arch": cfg.name, "attn_impl": cfg.attn_impl, "dtype": cfg.dtype,
            "n_layers": cfg.n_layers, "n_params": n_params,
            "batch": SERVE_BATCH, "prompt_positions": positions,
            "decode_steps": SERVE_DECODE, "init_params_s": init_s,
            "prefill_ms": prefill_s * 1e3,
            "prefill_positions_per_s": SERVE_BATCH * positions / prefill_s,
            "decode_ms_per_step": sum(step_s) / len(step_s) * 1e3,
            "decode_ms_steps": [x * 1e3 for x in step_s],
            "decode_tokens_per_s": SERVE_BATCH * len(step_s) / sum(step_s),
            "prefill_peak_bytes": prefill_peak}


def phase_serve_audio(torch) -> dict:
    """The audio encoder-decoder: whisper-base at its published size, bf16,
    ``attn_impl="dense"``, weights from ``init_params(0)``: 4 clips of
    1,500 random frame embeddings with 448-token prompts, one prefill
    (the encoder, then the decoder with its cross-attention k/v cached) and
    16 greedy decode steps, with the launch counts zeroed just before and
    read just after (no kernel: dense attention, the ``"xla"`` norms);
    finite logits; prefill + decode against a teacher-forced ``forward``
    (``SERVE_TOL``); ``attn_impl="pallas"`` raises ``NotImplementedError``
    before any launch, as in the reference."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    dev = torch.device("cuda")
    cfg = _audio_cfg()
    params, init_s = _sync_s(torch, lambda: lm.init_params(0, cfg))
    n_params = lm.param_count(params)
    check(n_params == AUDIO_PARAMS, f"{AUDIO_ARCH}: {n_params} params")
    gen = torch.Generator().manual_seed(27)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, AUDIO_PROMPT),
                           generator=gen).to(dev)
    stubs = {k: v.to(dev) for k, v in
             _stub_inputs(torch, cfg, SERVE_BATCH, gen).items()}
    check(stubs["frames"].shape == (SERVE_BATCH, 1500, cfg.d_model),
          f"frames {tuple(stubs['frames'].shape)}")
    lm.prefill(params, {"tokens": tokens[:, :16], **stubs}, cfg,
               max_len=32)                                          # warm
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    (logits, cache), prefill_s = _sync_s(
        torch, lambda: lm.prefill(params, {"tokens": tokens, **stubs}, cfg,
                                  max_len=AUDIO_PROMPT + SERVE_DECODE))
    after_prefill = ops.launch_counts()
    prefill_peak = torch.cuda.max_memory_allocated()
    generated, step_logits, step_s = _greedy_decode(
        torch, params, cache, logits, AUDIO_PROMPT, cfg)
    launches = ops.launch_counts()
    check(sum(launches.values()) == 0,
          f"{AUDIO_ARCH} (dense) launched a kernel: {launches}")
    _check_logits(torch, step_logits, cfg)
    cross = {k: tuple(v["xk"].shape) for k, v in cache.items()}
    check(all(sh[2] == 1500 for sh in cross.values()),
          f"cross-attention cache {cross}")
    del cache
    emit({"phase": "serve_audio", **_serve_record(
              cfg, n_params, init_s, prefill_s, step_s, AUDIO_PROMPT,
              prefill_peak),
          "frames": list(stubs["frames"].shape), "enc_layers":
          cfg.enc_layers, "cross_cache_shape": cross,
          "launches_prefill": after_prefill, "launches": launches,
          "reduced": "nothing"})
    seq = torch.cat([tokens] + generated, dim=1)
    full = lm.forward(params, {"tokens": seq, **stubs}, cfg)
    served = torch.stack([_vocab(lg, cfg) for lg in step_logits], dim=1)
    vs_forward = _compare(
        torch, served, full[:, AUDIO_PROMPT - 1:AUDIO_PROMPT + SERVE_DECODE],
        SERVE_TOL)
    del full
    ops.reset_launch_counts()
    try:
        lm.prefill(params, {"tokens": tokens, **stubs}, _audio_cfg("pallas"))
        raised = None
    except NotImplementedError as e:
        raised = str(e)
    k4 = ops.launch_counts()["flash_attention"]
    emit({"phase": "serve_audio_checks", "tolerance": SERVE_TOL,
          "prefill_decode_vs_forward": vs_forward,
          "pallas_raises": raised, "pallas_k4_launches": k4})
    check(vs_forward["close"], f"whisper prefill + decode vs forward: "
                               f"{vs_forward}")
    check(raised is not None and k4 == 0,
          f"whisper with attn_impl='pallas': raised {raised!r}, K4 {k4}")
    return {"params": params, "tokens": tokens, "stubs": stubs,
            "positions": AUDIO_PROMPT, "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": sum(step_s) / len(step_s) * 1e3}


def phase_serve_vlm(torch) -> dict:
    """The VLM: internvl2-26b at its published widths cut to 12 of 48
    layers, bf16, ``attn_impl="pallas"``, weights from ``init_params(0)``
    (5.8 B drawn on the CPU): 4 requests of 256 random patch embeddings
    and 2,048 tokens, one prefill over their 2,304 positions (K4 exactly
    once per layer, all on its wgmma route) and 16 greedy decode steps
    from position 2,304 (no K4), with the launch counts zeroed just before
    and read just after; finite logits; then the pallas prefill against
    the dense one and prefill + decode against a teacher-forced
    ``forward`` (``SERVE_TOL``)."""
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    dev = torch.device("cuda")
    cfg = _vlm_cfg()
    positions = _vlm_positions(cfg)
    params, init_s = _sync_s(torch, lambda: lm.init_params(0, cfg))
    n_params = lm.param_count(params)
    check(n_params == VLM_PARAMS, f"{VLM_ARCH}: {n_params} params")
    gen = torch.Generator().manual_seed(28)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen).to(dev)
    stubs = {k: v.to(dev) for k, v in
             _stub_inputs(torch, cfg, SERVE_BATCH, gen).items()}
    lm.prefill(params, {"tokens": tokens[:, :128], **stubs}, cfg,
               max_len=cfg.frontend_len + 144)                      # warm
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    (logits, cache), prefill_s = _sync_s(
        torch, lambda: lm.prefill(params, {"tokens": tokens, **stubs}, cfg,
                                  max_len=positions + SERVE_DECODE))
    after_prefill = ops.launch_counts()
    routes_prefill = dict(fl.ROUTE_LAUNCHES)
    prefill_peak = torch.cuda.max_memory_allocated()
    generated, step_logits, step_s = _greedy_decode(
        torch, params, cache, logits, positions, cfg)
    launches = ops.launch_counts()
    routes_decode = {k: n - routes_prefill[k]
                     for k, n in fl.ROUTE_LAUNCHES.items()}
    del cache
    check(after_prefill["flash_attention"] == cfg.n_layers,
          f"K4 launched {after_prefill['flash_attention']} times in a "
          f"prefill of {cfg.n_layers} layers")
    check(launches["flash_attention"] == cfg.n_layers,
          f"K4 launched in decode: {launches}")
    check(routes_prefill == {"simt": 0, "wgmma": cfg.n_layers},
          f"K4's prefill launches by route: {routes_prefill}")
    check(routes_decode == {"simt": 0, "wgmma": 0},
          f"K4's decode launches by route: {routes_decode}")
    _check_logits(torch, step_logits, cfg)
    emit({"phase": "serve_vlm", **_serve_record(
              cfg, n_params, init_s, prefill_s, step_s, positions,
              prefill_peak),
          "patches": list(stubs["patch_embed"].shape),
          "prompt_tokens": SERVE_PROMPT,
          "prefill_text_tokens_per_s": SERVE_BATCH * SERVE_PROMPT
          / prefill_s,
          "reduced": {"n_layers": f"{VLM_LAYERS} of 48 (drawing 19.9 B "
                      f"weights on the CPU would take 430-550 s)"},
          "launches_prefill": after_prefill,
          "launches_decode": {k: launches[k] - after_prefill[k]
                              for k in launches},
          "k4_routes_prefill": routes_prefill,
          "k4_routes_decode": routes_decode})
    dense_logits, _ = lm.prefill(params, {"tokens": tokens, **stubs},
                                 _vlm_cfg("dense"),
                                 max_len=positions + SERVE_DECODE)
    vs_dense = _compare(torch, _vocab(logits, cfg), _vocab(dense_logits, cfg),
                        SERVE_TOL)
    del dense_logits
    seq = torch.cat([tokens] + generated, dim=1)
    full = lm.forward(params, {"tokens": seq, **stubs}, cfg)
    served = torch.stack([_vocab(lg, cfg) for lg in step_logits], dim=1)
    vs_forward = _compare(
        torch, served, full[:, positions - 1:positions + SERVE_DECODE],
        SERVE_TOL)
    del full
    emit({"phase": "serve_vlm_checks", "tolerance": SERVE_TOL,
          "pallas_vs_dense_prefill": vs_dense,
          "prefill_decode_vs_forward": vs_forward})
    check(vs_dense["close"], f"VLM pallas vs dense prefill: {vs_dense}")
    check(vs_forward["close"], f"VLM prefill + decode vs forward: "
                               f"{vs_forward}")
    return {"params": params, "tokens": tokens, "stubs": stubs,
            "positions": positions, "launches": after_prefill,
            "k4_routes_prefill": routes_prefill,
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": sum(step_s) / len(step_s) * 1e3}


def _profile_rows(torch, prof):
    """(device rows, host rows) of a profile, each ``(us, name, count)``,
    largest first: kernels by self device time (an aten op's entry repeats
    its kernels', so only kernels count), host ops by self CPU time."""
    rows, host = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            if dev_us > 0:
                rows.append((dev_us, e.key, e.count))
        elif e.self_cpu_time_total > 0:
            host.append((e.self_cpu_time_total, e.key, e.count))
    return sorted(rows, reverse=True), sorted(host, reverse=True)


def _device_profile(torch, fn, label: str = "k4",
                    match: str = "flash_attention", top: int = 10,
                    groups: dict | None = None, host: bool = True) -> dict:
    """Wall time, device busy time and kernels of one call of ``fn`` under
    torch.profiler; ``<label>_ms`` sums the kernels whose name holds
    ``match``, and each of ``groups`` (name -> name fragments) the kernels
    whose name holds one of its fragments.  ``host=False`` records the
    device's activity alone: a call of ~10^5 launches then costs seconds
    to trace and to read back, where host events cost minutes."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows, _ = _profile_rows(torch, prof)
    busy = sum(r[0] for r in rows) / 1e6
    ours = sum(us for us, k, _ in rows if match in k) / 1e6
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
           "device_idle_share": 1 - busy / wall,
           "kernels_launched": sum(r[2] for r in rows),
           f"{label}_ms": ours * 1e3,
           f"{label}_launches": sum(n for _, k, n in rows if match in k),
           f"{label}_share_of_busy": ours / busy if busy else None,
           "top": [{"name": k[:80], "ms": us / 1e3, "count": n}
                   for us, k, n in rows[:top]]}
    for name, frags in (groups or {}).items():
        ms = sum(us for us, k, _ in rows if any(f in k for f in frags)) / 1e3
        out[f"{name}_ms"] = ms
        out[f"{name}_share_of_busy"] = ms / (busy * 1e3) if busy else None
    return out


def phase_serve_profile(torch, serve, cfg=None, *, label: str = "k4",
                        match: str = "flash_attention",
                        phase: str = "serve_profile",
                        groups: dict | None = None) -> dict:
    """Device busy and idle share of one serve prefill and one decode step
    (torch.profiler), with the serve phase's modality stubs (``stubs``)
    and prompt length in positions (``positions``) where it has them.
    The profiler slows the host, so the idle share is also given against
    the same call's unprofiled wall time from the serve phase."""
    from repro_torch.models import lm
    cfg = cfg or _serve_cfg()
    params, tokens = serve["params"], serve["tokens"]
    stubs = serve.get("stubs", {})
    prompt = serve.get("positions", tokens.shape[1])
    holder = {}

    def prefill():
        holder["out"] = lm.prefill(params, {"tokens": tokens, **stubs}, cfg,
                                   max_len=prompt + SERVE_DECODE)

    pre = _device_profile(torch, prefill, label, match, top=15,
                          groups=groups)
    logits, cache = holder["out"]
    nxt = logits.argmax(-1, keepdim=True)
    dec = _device_profile(torch, lambda: lm.decode_step(
        params, cache, nxt, prompt, cfg), label, match, groups=groups)
    for prof, key in ((pre, "prefill_ms"), (dec, "decode_ms_per_step")):
        prof["unprofiled_wall_ms"] = serve[key]
        prof["device_idle_share_unprofiled"] = \
            1 - prof["device_busy_ms"] / serve[key]
    out = {"phase": phase, "prefill": pre, "decode_step": dec}
    emit(out)
    return out


def phase_agree_lm(torch, arch: str, **impl) -> dict:
    """A reduced serve path (f32, with ``impl`` routing it through its
    kernel, and the arch's modality stub) on the card against the same on
    the CPU: prefill and 2 decode steps."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    cfg = replace(get_arch(arch).reduced(), **impl)
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (2, 14), generator=gen)
    stubs = _stub_inputs(torch, cfg, 2, gen)
    off = cfg.frontend_len if cfg.frontend == "patch" else 0
    out = {}
    for dev in ("cpu", "cuda"):
        params = lm.init_params(0, cfg, device=dev)
        lg, cache = lm.prefill(params, {"tokens": tokens[:, :12], **stubs},
                               cfg, max_len=off + 16, device=dev)
        steps = [lg]
        for i in range(2):
            lg, cache = lm.decode_step(params, cache, tokens[:, 12 + i:13 + i],
                                       off + 12 + i, cfg, device=dev)
            steps.append(lg)
        out[dev] = torch.stack([_vocab(x, cfg).cpu() for x in steps])
    res = _compare(torch, out["cuda"], out["cpu"], AGREE_LM_TOL)
    emit({"phase": "agree_lm", "arch": f"{arch} reduced", **res,
          "tolerance": AGREE_LM_TOL})
    check(res["close"], f"card vs CPU serve path: {res}")
    return res


def _finite_params(torch, eng) -> None:
    from repro_torch.kernels.layout import flatten_tree
    for k, v in flatten_tree(eng.params).items():
        check(bool(torch.isfinite(v).all()), f"param {k} not finite")


def run_main_path(torch, depth: int, rounds: int):
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_engine
    eng = build_engine(task="sr", pipeline_depth=depth)
    ops.reset_launch_counts()
    res = eng.run(rounds)
    launches = ops.launch_counts()
    torch.cuda.synchronize()
    for r in res:
        emit({"phase": "main", "depth": depth, "round": r.round_idx,
              "loss": r.loss, "s_steps": r.s_steps,
              "exec_time": r.exec_time, "wall_time": r.wall_time,
              "pack_time": r.pack_time, "overlap": r.overlap_fraction,
              "makespan": r.makespan, "idle_fraction": r.idle_fraction})
    _finite_params(torch, eng)
    return eng, res, launches


def phase_main(torch, rounds: int):
    eng1, res1, k1 = run_main_path(torch, 1, rounds)
    _, res0, k0 = run_main_path(torch, 0, rounds)
    l1, l0 = [r.loss for r in res1], [r.loss for r in res0]
    check(all(math.isfinite(x) for x in l1), f"non-finite losses {l1}")
    check(l1 == l0, f"depth 1 and depth 0 losses differ: {l1} vs {l0}")
    steps1 = sum(r.s_steps for r in res1)
    steps0 = sum(r.s_steps for r in res0)
    check(k1["fedavg_accum"] >= steps1 > 0,
          f"K1 launched {k1} times for {steps1} round steps (depth 1)")
    check(k0["fedavg_accum"] >= steps0,
          f"K1 launched {k0} times for {steps0} round steps (depth 0)")
    n_params = sum(v.numel() for v in eng1.params.values())
    check(n_params == SR_PARAMS, f"SR has {n_params} params, not 4,244,992")
    emit({"phase": "main_summary", "rounds": rounds, "losses": l1,
          "bit_identical_depth_0_1": True, "launches_depth1": k1,
          "launches_depth0": k0, "s_steps_total": steps1,
          "n_params": n_params, "n_leaves": len(eng1.params),
          "mean_exec_s": sum(r.exec_time for r in res1[1:])
          / max(len(res1) - 1, 1),
          "recompiles": res1[-1].recompiles})
    return k1["fedavg_accum"], steps1, res1


def run_mesh_path(torch, depth: int, rounds: int):
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_engine
    eng = build_engine(task="sr", pipeline_depth=depth, **MESH)
    ops.reset_launch_counts()
    res = eng.run(rounds)
    launches = ops.launch_counts()
    torch.cuda.synchronize()
    for r in res:
        emit({"phase": "mesh", "depth": depth, "round": r.round_idx,
              "loss": r.loss, "s_steps": r.s_steps,
              "exec_time": r.exec_time, "wall_time": r.wall_time,
              "pack_time": r.pack_time, "overlap": r.overlap_fraction,
              "combine_bytes": r.combine_bytes,
              "residual_norm": r.residual_norm,
              "padded_steps": r.padded_steps,
              "critical_path": r.critical_path})
    _finite_params(torch, eng)
    return eng, res, launches


def phase_mesh(torch, rounds: int):
    """The slice's path at depths 1 and 0 from the same seed."""
    eng, res1, k1 = run_mesh_path(torch, 1, rounds)
    _, res0, k0 = run_mesh_path(torch, 0, rounds)
    l1, l0 = [r.loss for r in res1], [r.loss for r in res0]
    check(all(math.isfinite(x) for x in l1), f"non-finite losses {l1}")
    check(l1 == l0, f"mesh depth 1 and depth 0 losses differ: {l1} vs {l0}")
    shards = MESH["mesh_workers"]
    for k in (k1, k0):
        check(k["dequant_merge"] == shards * rounds,
              f"K2 launched {k} times, want {shards} per round")
    # Every worker program runs the round's S steps (bucket_mode="round").
    steps = MESH["workers"] * sum(r.s_steps for r in res1)
    check(k1["fedavg_accum"] == steps,
          f"K1 launched {k1['fedavg_accum']} times for {steps} steps")
    want = shards * INT8_PAYLOAD
    check(all(r.combine_bytes == want for r in res1 + res0),
          f"combine_bytes {[r.combine_bytes for r in res1]} != {want}")
    emit({"phase": "mesh_summary", "rounds": rounds, "losses": l1,
          "bit_identical_depth_0_1": True, "launches_depth1": k1,
          "launches_depth0": k0, "combine_bytes_per_round": want,
          "mean_exec_s": sum(r.exec_time for r in res1[1:])
          / max(len(res1) - 1, 1),
          "compile_stats": eng.compile_stats})
    return k1, res1


def _lane_batch_invariance(torch) -> dict:
    """Does a lane's result depend on how many lanes share its GEMMs?  The
    SR worker step at the published widths over 8 lanes at once, against
    the same lanes in groups of 4, 2 and 1 (bitwise, per group size)."""
    from repro_torch.fl.round import make_worker_round_step
    from repro_torch.models.papertasks import make_task_model
    from repro_torch.optim import sgd
    dev = torch.device("cuda")
    params, loss_fn = make_task_model("sr", 1337, device=dev)
    step = make_worker_round_step(loss_fn, sgd(0.05, momentum=0.9,
                                               weight_decay=5e-4))
    gen = torch.Generator().manual_seed(4)
    L, S, B = 8, 4, 20
    batch = {"x": torch.randn(L, 1, S, B, 64, generator=gen).to(dev),
             "y": torch.randint(0, 35, (L, 1, S, B), generator=gen,
                                dtype=torch.int32).to(dev)}
    mask = torch.ones(L, 1, S, device=dev)
    bnd = torch.zeros(L, 1, S, device=dev)
    bnd[..., 1] = bnd[..., 3] = 1.0
    wt = bnd * 20.0

    def run(g):
        outs = [step(params, {k: v[i:i + g].reshape((1, g) + v.shape[2:])
                              for k, v in batch.items()},
                     *(m[i:i + g].reshape(1, g, S) for m in (mask, bnd, wt)))
                for i in range(0, L, g)]
        return (torch.cat([o[0].flat.reshape(g, -1) for o in outs]),
                torch.cat([o[2].reshape(-1) for o in outs]))

    theta8, loss8 = run(8)
    same = {}
    for g in (4, 2, 1):
        theta, loss = run(g)
        same[g] = bool(torch.equal(theta, theta8) and torch.equal(loss, loss8))
    return same


def phase_decomposition(torch):
    """Bit-identity of the mesh decomposition at the published widths."""
    from repro_torch.launch.train import build_engine

    same = _lane_batch_invariance(torch)
    check(same[4] and same[2], f"lane results depend on the lane batch: "
                               f"{same}")

    def losses(rounds, **kw):
        res = build_engine(task="sr", workers=4, **kw).run(rounds)
        return [r.loss for r in res]

    fused = losses(2)
    flat = {k: losses(2, mesh_workers=k) for k in (2, 4)}
    for k, ls in flat.items():
        check(ls == fused, f"flat mesh {k} {ls} != fused {fused}")
    hosts = {}
    for compress in ("none", "int8"):
        runs = [losses(2, mesh_workers=4, combine_mode="tree",
                       combine_compress=compress, hosts=h) for h in (1, 2)]
        check(runs[0] == runs[1],
              f"hosts 1 vs 2 ({compress}): {runs[0]} vs {runs[1]}")
        hosts[compress] = runs[0]
    topk = losses(1, mesh_workers=2, combine_mode="tree",
                  combine_compress="topk")
    check(all(math.isfinite(x) for x in topk), f"topk losses {topk}")
    emit({"phase": "decomposition",
          "lane_batch_bitwise_vs_8": {str(k): v for k, v in same.items()},
          "fused": fused,
          "flat_mesh_bitwise": {str(k): True for k in flat},
          "hosts_1_vs_2_bitwise": {k: True for k in hosts},
          "hosts_losses": hosts, "topk": topk})


def phase_agree(torch):
    """A small SR engine on the card tracks the same engine on the CPU."""
    from repro_torch.core import (EngineConfig, FederatedEngine,
                                  SyntheticTelemetry, UniformSampler,
                                  make_placement)
    from repro_torch.data import make_federated_dataset
    from repro_torch.distributed import WorkerPool
    from repro_torch.models.papertasks import make_task_model
    from repro_torch.optim import sgd
    ds = make_federated_dataset("sr", n_clients=64, batch_size=4,
                                size_mu=2.5, size_sigma=0.8)
    losses = {}
    for dev in ("cpu", "cuda"):
        params, loss = make_task_model("sr", 0, width=64, n_blocks=2,
                                       device="cpu")
        eng = FederatedEngine(
            dataset=ds, loss_fn=loss, init_params=params,
            optimizer=sgd(0.05, momentum=0.9, weight_decay=5e-4),
            placement=make_placement("lb"), sampler=UniformSampler(64, 4),
            pool=WorkerPool.homogeneous(2, type_name="a40", concurrency=2),
            telemetry=SyntheticTelemetry(),
            config=EngineConfig(steps_cap=4, batch_size=4,
                                lanes_per_worker=2),
            device=dev)
        losses[dev] = [r.loss for r in eng.run(3)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    check(rel <= 1e-4, f"card vs CPU losses differ by {rel}: {losses}")
    emit({"phase": "agree", "losses": losses, "max_rel_diff": rel,
          "rtol": 1e-4})


def phase_profile(torch, out_dir: str, label: str, **kw) -> None:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.train import build_engine
    out = Path(out_dir) / label
    out.mkdir(parents=True, exist_ok=True)
    eng = build_engine(task="sr", **kw)
    eng.run(1)                                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run(2)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(out / "trace.json"))
    rows, host = _profile_rows(torch, prof)
    busy_s = sum(r[0] for r in rows) / 1e6

    def table(entries):
        return "\n".join(f"{us / 1e3:10.3f} ms {n:6d}x {k}"
                         for us, k, n in entries)

    (out / "kernels.txt").write_text(table(rows))
    (out / "host_ops.txt").write_text(table(host))   # self CPU time
    emit({"phase": "profile", "path": label, "rounds": 2, "wall_s": wall,
          "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall,
          "host_self_s": sum(r[0] for r in host) / 1e6,
          "top": [{"name": k[:80], "ms": us / 1e3, "count": n}
                  for us, k, n in rows[:12]],
          "ours": [{"name": k[:80], "ms": us / 1e3, "count": n,
                    "share": us / 1e6 / busy_s}
                   for us, k, n in rows if "fedavg" in k or "dequant" in k],
          "top_host": [{"name": k[:60], "ms": us / 1e3, "count": n}
                       for us, k, n in host[:8]]})


def _lm_shapes(cfg) -> dict:
    """``{path: shape}`` of an LM config's parameters (nothing drawn)."""
    from repro_torch.kernels.layout import flatten_tree
    from repro_torch.models import lm
    return flatten_tree(lm.param_shapes(cfg))


def _lm_cli(torch, argv: list, depth: int):
    """One run of the training CLI (``repro_torch.launch.train.main``) at
    ``depth``: its summary, per-round history, the launch counts (zeroed
    just before the run and read just after) and the run's peak device
    memory."""
    import contextlib
    import gc
    import io
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "metrics.json"
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = train.main(argv + ["--pipeline-depth", str(depth),
                                    "--metrics-out", str(path)])
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        rec = json.loads(path.read_text())
    gc.collect()
    torch.cuda.empty_cache()
    check(rc == 0, f"{argv}: exit {rc}")
    check(rec["summary"]["kernel_launches"] == launches,
          f"{argv}: the summary's launches {rec['summary']} != {launches}")
    return rec["summary"], rec["history"], launches, peak


def _mean_exec(hist) -> float:
    """Mean ``exec_time`` of the rounds after the first (round 0 pays for
    first-call allocations)."""
    later = [h["exec_time"] for h in hist[1:]] or [hist[0]["exec_time"]]
    return sum(later) / len(later)


def _moe_aux_in_loss(torch) -> dict:
    """The fl100m granite-moe loss holds ``moe_aux_weight`` times the MoE
    layers' load-balance term: ``loss_fn`` at the config's weight minus at
    weight 0 equals it (to f32 rounding of a ~10 loss), and the term, a sum
    of 12 layers' (each 1 at uniform routing), is positive."""
    from dataclasses import replace
    from repro_torch.launch.train import lm_config
    from repro_torch.models import lm
    cfg, seq_len, batch = lm_config(MOE_ARCH, "fl100m")
    params = lm.init_params(0, cfg)
    gen = torch.Generator().manual_seed(16)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq_len), generator=gen)
    with torch.no_grad():
        loss = float(lm.loss_fn(params, {"tokens": toks}, cfg))
        bare = float(lm.loss_fn(params, {"tokens": toks},
                                replace(cfg, moe_aux_weight=0.0)))
        aux = float(lm._hidden(params, {"tokens": toks}, cfg,
                               torch.device("cuda"))[2])
    del params
    out = {"loss": loss, "loss_without_aux": bare, "aux": aux,
           "moe_aux_weight": cfg.moe_aux_weight}
    check(aux > 0
          and abs(loss - bare - cfg.moe_aux_weight * aux) <= 1e-5 * loss,
          f"the MoE loss does not hold its aux term: {out}")
    return out


def phase_train_lm(torch) -> dict:
    """``--arch ... --preset fl100m`` through the CLI at depths 1 and 0:
    finite losses, bit-identical across depths, K1 once per lane-loop
    step; the MoE arch's loss holds its load-balance term."""
    from repro_torch.launch.train import lm_config
    out = {}
    for arch, rounds in LM_TRAIN:
        argv = ["--arch", arch, "--preset", "fl100m", "--rounds", str(rounds)]
        runs = {}
        for depth in (1, 0):
            _, hist, launches, peak = _lm_cli(torch, argv, depth)
            losses = [h["loss"] for h in hist]
            steps = sum(h["s_steps"] for h in hist)
            for h in hist:
                emit({"phase": "train_lm", "arch": arch, "depth": depth,
                      "round": h["round_idx"], "loss": h["loss"],
                      "s_steps": h["s_steps"], "exec_time": h["exec_time"],
                      "wall_time": h["wall_time"],
                      "pack_time": h["pack_time"],
                      "overlap": h["overlap_fraction"]})
            check(len(losses) == rounds
                  and all(math.isfinite(x) for x in losses),
                  f"{arch} fl100m depth {depth}: losses {losses}")
            check(launches["fedavg_accum"] == steps > 0,
                  f"{arch} fl100m depth {depth}: K1 launched "
                  f"{launches['fedavg_accum']} times for {steps} steps")
            runs[depth] = (losses, launches, hist, peak)
        check(runs[1][0] == runs[0][0],
              f"{arch}: depth 1 and 0 losses differ: {runs[1][0]} vs "
              f"{runs[0][0]}")
        cfg, seq_len, batch = lm_config(arch, "fl100m")
        shapes = _lm_shapes(cfg)
        hist = runs[1][2]
        out[arch] = {"launches": runs[1][1]["fedavg_accum"],
                     "launches_depth0": runs[0][1]["fedavg_accum"],
                     "mean_exec_s": _mean_exec(hist),
                     "peak_gb": runs[1][3] / 1e9}
        emit({"phase": "train_lm_summary", "arch": arch, "preset": "fl100m",
              "rounds": rounds, "losses": runs[1][0],
              "bit_identical_depth_0_1": True,
              "n_params": sum(math.prod(s) for s in shapes.values()),
              "n_leaves": len(shapes), "seq_len": seq_len, "batch": batch,
              "lanes": 4, "s_steps": [h["s_steps"] for h in hist],
              "exec_time": [h["exec_time"] for h in hist],
              "launches_depth1": runs[1][1], "launches_depth0": runs[0][1],
              **({"aux_in_loss": _moe_aux_in_loss(torch)}
                 if arch == MOE_ARCH else {}),
              **out[arch]})
    return out


def phase_train_lm_mesh(torch) -> dict:
    """The fl100m qwen3 on the mesh path (4 workers over 2 shards, tree
    combine, int8 uploads) at depths 1 and 0: bit-identical losses, K2
    once per live shard per round over the LM's leaf table, K1 once per
    worker-program step."""
    from repro_torch.launch.train import lm_config
    argv = (["--arch", SERVE_ARCH, "--preset", "fl100m", "--rounds",
             str(LM_MESH_ROUNDS)] + LM_MESH_ARGS)
    shapes = _lm_shapes(lm_config(SERVE_ARCH, "fl100m")[0])
    payload = sum(math.prod(s) for s in shapes.values()) + 4 * len(shapes) \
        + 8                                  # int8 body, scales, 2 scalars
    shards, workers = 2, 4
    runs = {}
    for depth in (1, 0):
        summary, hist, launches, _ = _lm_cli(torch, argv, depth)
        for h in hist:
            emit({"phase": "train_lm_mesh", "depth": depth,
                  "round": h["round_idx"], "loss": h["loss"],
                  "s_steps": h["s_steps"], "exec_time": h["exec_time"],
                  "wall_time": h["wall_time"],
                  "combine_bytes": h["combine_bytes"],
                  "residual_norm": h["residual_norm"]})
        losses = [h["loss"] for h in hist]
        check(all(math.isfinite(x) for x in losses),
              f"LM mesh depth {depth}: losses {losses}")
        check(launches["dequant_merge"] == shards * LM_MESH_ROUNDS,
              f"LM mesh: K2 launched {launches}, want {shards} a round")
        steps = workers * sum(h["s_steps"] for h in hist)
        check(launches["fedavg_accum"] == steps,
              f"LM mesh: K1 launched {launches['fedavg_accum']} times for "
              f"{steps} worker-program steps")
        check(summary["combine_bytes_per_round"] == shards * payload,
              f"LM mesh: combine_bytes {summary['combine_bytes_per_round']}"
              f" != {shards} x {payload}")
        runs[depth] = (losses, launches, hist, summary)
    check(runs[1][0] == runs[0][0], f"LM mesh: depth 1 and 0 losses "
                                    f"differ: {runs[1][0]} vs {runs[0][0]}")
    hist = runs[1][2]
    out = {"launches": runs[1][1], "mean_exec_s": _mean_exec(hist),
           "combine_bytes_per_round": runs[1][3]["combine_bytes_per_round"]}
    emit({"phase": "train_lm_mesh_summary", "arch": SERVE_ARCH,
          "preset": "fl100m", "rounds": LM_MESH_ROUNDS, "losses": runs[1][0],
          "bit_identical_depth_0_1": True, "leaves": len(shapes),
          "payload_bytes": payload,
          "exec_time": [h["exec_time"] for h in hist],
          "launches_depth0": runs[0][1], **out})
    return out


def phase_train_full(torch) -> dict:
    """qwen3-0.6b at its published widths in f32 through ``build_engine``
    (``lm_cfg``): 2 rounds at depths 1 and 0, bit-identical losses, K1
    once per step over the ``[2, 596,180,992]`` lane buffer; peak memory,
    ``exec_time``, and a profiled third round at depth 1."""
    import gc
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.layout import flatten_tree
    from repro_torch.launch.train import PRESETS, build_engine
    cfg = replace(get_arch(SERVE_ARCH), dtype="float32")
    lanes = FULL["workers"] * FULL["concurrency"]
    runs, prof = {}, None
    for depth in (1, 0):
        t0 = time.perf_counter()
        eng = build_engine(lm_cfg=cfg, pipeline_depth=depth, **FULL)
        build_s = time.perf_counter() - t0
        n = sum(v.numel() for v in flatten_tree(eng.params).values())
        check(n == SERVE_PARAMS, f"qwen3-0.6b has {n} params")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = eng.run(FULL_ROUNDS)
        launches = ops.launch_counts()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        for r in res:
            emit({"phase": "train_full", "depth": depth,
                  "round": r.round_idx, "loss": r.loss, "s_steps": r.s_steps,
                  "padded_steps": r.padded_steps,
                  "exec_time": r.exec_time, "wall_time": r.wall_time,
                  "pack_time": r.pack_time, "overlap": r.overlap_fraction})
        losses = [r.loss for r in res]
        steps = sum(r.s_steps for r in res)
        real = lanes * steps - sum(r.padded_steps for r in res)
        check(all(math.isfinite(x) for x in losses),
              f"full width depth {depth}: losses {losses}")
        check(launches["fedavg_accum"] == steps,
              f"full width: K1 launched {launches['fedavg_accum']} times "
              f"for {steps} steps")
        _finite_params(torch, eng)
        if depth == 1:
            prof = _device_profile(torch, lambda: eng.run(1), label="k1",
                                   match="fedavg", top=12)
            emit({"phase": "train_full_profile", "rounds": 1, **prof})
        runs[depth] = {"losses": losses, "launches": launches["fedavg_accum"],
                       "steps": steps, "real_lane_steps": real,
                       "peak_bytes": peak,
                       "exec_time": [r.exec_time for r in res],
                       "wall_time": [r.wall_time for r in res],
                       "build_s": build_s}
        del eng, res
        gc.collect()
        torch.cuda.empty_cache()
    check(runs[1]["losses"] == runs[0]["losses"],
          f"full width: depth 1 and 0 losses differ: {runs[1]['losses']} "
          f"vs {runs[0]['losses']}")
    out = {"launches": runs[1]["launches"], "k1_shape": [lanes, SERVE_PARAMS],
           "peak_gb": runs[1]["peak_bytes"] / 1e9,
           "mean_exec_s": sum(runs[1]["exec_time"]) / FULL_ROUNDS,
           "exec_s_per_real_lane_step": (sum(runs[1]["exec_time"])
                                         / runs[1]["real_lane_steps"]),
           "device_idle_share": prof["device_idle_share"],
           "k1_share_of_busy": prof["k1_share_of_busy"]}
    emit({"phase": "train_full_summary", "arch": SERVE_ARCH,
          "n_params": SERVE_PARAMS, "dtype": "float32", **FULL,
          "seq_len": PRESETS[FULL["preset"]]["seq_len"],
          "batch": PRESETS[FULL["preset"]]["batch_size"],
          "rounds": FULL_ROUNDS, "bit_identical_depth_0_1": True,
          "reduced": {"dtype": "float32 (published: bfloat16)",
                      "lanes": lanes, "rounds": FULL_ROUNDS},
          "depth1": runs[1], "depth0": runs[0], **out})
    return out


def phase_lm_fold(torch, device_name: str) -> dict:
    """K1 at the full-width round's own call, ``[2, 596,180,992]`` f32
    with per-lane weights: bitwise against its plain version, then timed
    with it and ``torch.lerp`` beside the bytes bound.  Inputs are drawn
    on the card (9.5 GB)."""
    from repro_torch.kernels import fedavg_accum as fa
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    lanes, n = FULL["workers"] * FULL["concurrency"], SERVE_PARAMS
    acc = torch.randn(lanes, n, generator=gen, device=dev)
    theta = torch.randn(lanes, n, generator=gen, device=dev)
    n_old = torch.tensor([0.0, 7.0], device=dev)
    n_k = torch.tensor([4.0, 2.0], device=dev)
    got = fa.fedavg_accum_lanes(acc, theta, n_old, n_k)
    want = ref.fedavg_accum_ref(acc, theta, n_old, n_k)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"K1 at [{lanes}, {n}]: max err {err}")
    del got, want
    lerp_w = (n_k / (n_old + n_k))[:, None]
    runs = {"kernel": lambda: fa.fedavg_accum_lanes(acc, theta, n_old, n_k),
            "plain": lambda: ref.fedavg_accum_ref(acc, theta, n_old, n_k),
            "library": lambda: torch.lerp(acc, theta, lerp_w)}
    best = _best_of(runs, (("kernel", "plain", "library"),
                           ("library", "plain", "kernel"),
                           ("kernel", "plain", "library")), iters=10)
    elems = lanes * n
    nbytes = 3 * elems * 4                        # 2 reads + 1 write
    bytes_ms = nbytes / mem_bw(device_name) * 1e3
    ops_ms = 4 * elems / F32_FLOPS * 1e3
    out = {"shape": [lanes, n], "max_abs_err": err, "ms": best["kernel"],
           "plain_ms": best["plain"], "library_ms": best["library"],
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes}
    out["roofline_share"] = out["bound_ms"] / best["kernel"]
    emit({"phase": "timing", "kernel": "fedavg_accum",
          "path": "train LM full width", **out})
    del acc, theta
    torch.cuda.empty_cache()
    return out


def phase_k2_lm(torch, device_name: str) -> dict:
    """K2 on one shard's fold of the fl100m qwen3 payload, over the LM's
    leaf table: bitwise against its plain version at the weight edges,
    then timed."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.layout import FlatLayout
    from repro_torch.launch.train import lm_config
    shapes = _lm_shapes(lm_config(SERVE_ARCH, "fl100m")[0])
    layout = FlatLayout({k: torch.empty(s, device="meta")
                         for k, s in shapes.items()})
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    acc, q, g = _payload(torch, layout.n, gen, dev)
    scales = (torch.rand(len(layout.names), generator=gen) * 0.02).to(dev)
    offsets = layout.offsets_on(dev)
    for edge in EDGES:
        n_old, n_k = (torch.tensor(w, device=dev) for w in edge)
        got = ops.dequant_merge_flat(acc, q, g, scales, offsets, n_old, n_k)
        want = ref.dequant_merge_flat_ref(acc, q, g, scales, offsets,
                                          n_old, n_k)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K2 LM payload {edge}: max err "
                                      f"{float((got - want).abs().max())}")
    del acc, q, g, got, want
    return phase_timing_k2(torch, layout, device_name)


def _worst_ratio(got: dict, want: dict, rtol: float, atol: float) -> float:
    """max over leaves of ``|got - want| / (atol + rtol·|want|)``: the check
    holds where it is at most 1."""
    return max(float(((got[k].cpu() - w).abs() / (atol + rtol * w.abs()))
                     .max()) for k, w in want.items())


def phase_agree_train(torch) -> dict:
    """A reduced qwen3-0.6b training engine, 2 rounds on the card against
    the same on the CPU: the losses, and the final params leaf by leaf;
    the initial params are the control that the params check must
    refuse."""
    from repro_torch.kernels.layout import flatten_tree
    from repro_torch.launch.train import build_engine
    losses, final = {}, {}
    for dev in ("cpu", "cuda"):
        eng = build_engine(arch=SERVE_ARCH, preset="smoke", device=dev,
                           cohort=4, steps_cap=2, population=64)
        if dev == "cpu":
            init = {k: v.clone() for k, v in flatten_tree(eng.params).items()}
        losses[dev] = [r.loss for r in eng.run(2)]
        final[dev] = flatten_tree(eng.params)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    check(set(final["cuda"]) == set(final["cpu"]), "card vs CPU leaves")
    params = _worst_ratio(final["cuda"], final["cpu"], **AGREE_TRAIN_PARAMS)
    control = _worst_ratio(init, final["cpu"], **AGREE_TRAIN_PARAMS)
    emit({"phase": "agree_train", "arch": f"{SERVE_ARCH} reduced",
          "losses": losses, "max_rel_diff": rel, "rtol": AGREE_TRAIN_RTOL,
          "params_tol": AGREE_TRAIN_PARAMS, "params_worst_ratio": params,
          "init_params_worst_ratio": control})
    check(rel <= AGREE_TRAIN_RTOL,
          f"card vs CPU LM training losses differ by {rel}: {losses}")
    check(params <= 1.0, f"card vs CPU LM params: {params}x the tolerance")
    check(control > 1.0, f"the untrained params pass the params check "
                         f"({control}x the tolerance)")
    return {"max_rel_diff": rel, "params_worst_ratio": params}


def _task_run(torch, task: str, depth: int):
    """``build_engine(task=...)`` at ``depth``: its results, the launch
    counts (zeroed just before the run and read just after) and the run's
    peak device memory."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_engine
    eng = build_engine(task=task, pipeline_depth=depth)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = eng.run(TASK_ROUNDS)
    launches = ops.launch_counts()
    torch.cuda.synchronize()
    return eng, res, launches, torch.cuda.max_memory_allocated()


def phase_train_tasks(torch, device_name: str) -> dict:
    """IC, TG and MLM at their full sizes through ``build_engine(task=t)``
    at depths 1 and 0: finite losses, bitwise across depths, K1 once per
    lane-loop step; the parameter count, ``exec_time`` per round, peak
    memory, a profiled round, and K1 timed at the task's ``[4, N]`` lane
    buffer beside its plain version, ``torch.lerp`` and the bound."""
    import gc
    out = {}
    for task in ("ic", "tg", "mlm"):
        t0 = time.perf_counter()
        runs = {}
        for depth in (1, 0):
            eng, res, launches, peak = _task_run(torch, task, depth)
            for r in res:
                emit({"phase": "train_tasks", "task": task, "depth": depth,
                      "round": r.round_idx, "loss": r.loss,
                      "s_steps": r.s_steps, "exec_time": r.exec_time,
                      "wall_time": r.wall_time, "pack_time": r.pack_time,
                      "overlap": r.overlap_fraction})
            losses = [r.loss for r in res]
            steps = sum(r.s_steps for r in res)
            check(all(math.isfinite(x) for x in losses),
                  f"{task} depth {depth}: losses {losses}")
            check(launches["fedavg_accum"] == steps > 0,
                  f"{task} depth {depth}: K1 launched "
                  f"{launches['fedavg_accum']} times for {steps} steps")
            _finite_params(torch, eng)
            n = sum(v.numel() for v in eng.params.values())
            check(n == TASK_PARAMS[task], f"{task} has {n} params")
            runs[depth] = {"losses": losses, "launches": launches,
                           "steps": steps, "peak_bytes": peak,
                           "exec_time": [r.exec_time for r in res]}
            if depth == 1:
                # TG's round is ~2 x 10^5 launches: its device alone.
                tp = time.perf_counter()
                prof = _device_profile(torch, lambda: eng.run(1), label="k1",
                                       match="fedavg", top=8,
                                       host=task != "tg")
                prof["seconds"] = time.perf_counter() - tp
            del eng, res
            gc.collect()
            torch.cuda.empty_cache()
        check(runs[1]["losses"] == runs[0]["losses"],
              f"{task}: depth 1 and 0 losses differ: {runs[1]['losses']} "
              f"vs {runs[0]['losses']}")
        fold = phase_timing(torch, TASK_PARAMS[task], 4, device_name)
        out[task] = {"launches": runs[1]["launches"]["fedavg_accum"],
                     "launches_depth0": runs[0]["launches"]["fedavg_accum"],
                     "n_params": TASK_PARAMS[task],
                     "exec_time": runs[1]["exec_time"],
                     "peak_gb": runs[1]["peak_bytes"] / 1e9,
                     "device_idle_share": prof["device_idle_share"],
                     "k1_share_of_busy": prof["k1_share_of_busy"],
                     "fold": {k: fold[k] for k in (
                         "shape", "ms", "plain_ms", "library_ms",
                         "bound_ms", "bound_by")}}
        out[task]["seconds"] = time.perf_counter() - t0
        emit({"phase": "train_tasks_summary", "task": task,
              "rounds": TASK_ROUNDS, "losses": runs[1]["losses"],
              "bit_identical_depth_0_1": True, "lanes": 4,
              "s_steps_total": runs[1]["steps"],
              "exec_time_depth0": runs[0]["exec_time"],
              "peak_gb_depth0": runs[0]["peak_bytes"] / 1e9,
              "profile": prof, **out[task]})
    return out


class _RecordReduce:
    """Wraps a strategy to keep the last round's stacked models."""

    def __init__(self, inner):
        self.inner = inner
        self.associative = inner.associative
        self.name = inner.name
        self.last = None

    def reduce(self, stacked, weights, global_params):
        self.last = stacked["flat"]
        return self.inner.reduce(stacked, weights, global_params)


def phase_fedmedian(torch) -> dict:
    """``build_engine(task="sr", strategy="fedmedian")`` at SR's published
    widths, 3 rounds at depths 0 and 1: finite losses, bitwise across
    depths, no K1 launch (nothing folds on the gather path); the card's
    median of one round's ``[4, N]`` models against the CPU's, bitwise,
    and the reduce timed."""
    from repro_torch.core.aggregation import median_leading
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_engine
    runs = {}
    for depth in (0, 1):
        eng = build_engine(task="sr", strategy="fedmedian",
                           pipeline_depth=depth)
        eng.strategy = rec = _RecordReduce(eng.strategy)
        ops.reset_launch_counts()
        res = eng.run(FEDMEDIAN_ROUNDS)
        launches = ops.launch_counts()
        torch.cuda.synchronize()
        for r in res:
            emit({"phase": "fedmedian", "depth": depth, "round": r.round_idx,
                  "loss": r.loss, "s_steps": r.s_steps,
                  "exec_time": r.exec_time, "wall_time": r.wall_time})
        _finite_params(torch, eng)
        runs[depth] = ([r.loss for r in res], launches, res)
    losses, launches, res = runs[1]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(runs[0][0] == losses,
          f"fedmedian depth 0 and 1 differ: {runs[0][0]} vs {losses}")
    for d in (0, 1):
        check(sum(runs[d][1].values()) == 0,
              f"the gather path launched kernels: {runs[d][1]}")
    stacked = rec.last
    card = median_leading(stacked)
    cpu = median_leading(stacked.cpu())
    check(torch.equal(card.cpu(), cpu),
          "the card's median differs from the CPU's")
    # A diverged client: a NaN in one model makes its column NaN (as
    # jnp.median does); +-inf columns and the finite rest stay bitwise.
    sick = stacked.clone()
    sick[1, 7] = float("nan")
    sick[0, 11], sick[2, 11] = float("inf"), float("-inf")
    sick[0, 12] = float("inf")
    card_s, cpu_s = median_leading(sick).cpu(), median_leading(sick.cpu())
    nan = torch.isnan(cpu_s)
    check(bool(nan[7]) and torch.equal(torch.isnan(card_s), nan)
          and int(nan.sum()) == int(torch.isnan(sick).any(0).sum().cpu())
          and torch.equal(card_s[~nan], cpu_s[~nan]),
          "the card's median of a model with NaN/inf differs from the "
          "CPU's or drops the NaN")
    reduce_ms = time_ms(lambda: median_leading(stacked), iters=10)
    out = {"losses": losses, "bit_identical_depth_0_1": True,
           "launches_depth1": launches, "launches_depth0": runs[0][1],
           "stacked_shape": list(stacked.shape),
           "median_card_equals_cpu": True,
           "median_nan_column_is_nan": True, "median_ms": reduce_ms,
           "mean_exec_s": sum(r.exec_time for r in res[1:])
           / max(len(res) - 1, 1)}
    emit({"phase": "fedmedian_summary", "rounds": FEDMEDIAN_ROUNDS, **out})
    return out


def _resume_case(torch, label: str, **kw) -> dict:
    """``RESUME_ROUNDS`` rounds with a checkpoint every ``RESUME_EVERY``,
    then 2 more in a new engine restored from it, against rounds 4-5 of an
    uninterrupted run: bitwise.  The checkpoint's bytes and a save timed
    on the card's engine."""
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_engine
    total = RESUME_ROUNDS + 2
    whole = [r.loss for r in build_engine(task="sr", **kw).run(total)]
    with tempfile.TemporaryDirectory() as tmp:
        first = build_engine(task="sr", ckpt_dir=tmp,
                             rounds_per_checkpoint=RESUME_EVERY, **kw)
        first.run(RESUME_ROUNDS)
        files = sorted(Path(tmp).glob(f"round_{RESUME_ROUNDS:08d}*"))
        nbytes = {f.name: f.stat().st_size for f in files}
        t0 = time.perf_counter()
        first.save_checkpoint()
        save_s = time.perf_counter() - t0
        eng = build_engine(task="sr", ckpt_dir=tmp, **kw)
        t0 = time.perf_counter()
        check(eng.restore_latest() and eng.round_idx == RESUME_ROUNDS,
              f"{label}: restore failed at round {eng.round_idx}")
        restore_s = time.perf_counter() - t0
        ops.reset_launch_counts()
        resumed = [r.loss for r in eng.run(2)]
        launches = ops.launch_counts()
    out = {"case": label, "whole": whole, "resumed": resumed,
           "bitwise": resumed == whole[RESUME_ROUNDS:],
           "checkpoint_bytes": nbytes,
           "checkpoint_total_bytes": sum(nbytes.values()),
           "save_s": save_s, "restore_s": restore_s,
           "launches_resumed": launches}
    emit({"phase": "resume", **out})
    check(out["bitwise"], f"{label}: resumed losses {resumed} != "
                          f"{whole[RESUME_ROUNDS:]}")
    check(all(math.isfinite(x) for x in whole), f"{label}: {whole}")
    return out


def phase_resume(torch) -> dict:
    fused = _resume_case(torch, "fused")
    mesh = _resume_case(torch, "mesh_int8", **MESH)
    check(mesh["launches_resumed"]["dequant_merge"]
          == 2 * MESH["mesh_workers"],
          f"K2 launches on the resumed mesh run: {mesh['launches_resumed']}")
    check(any(k.endswith(".aux.npz") for k in mesh["checkpoint_bytes"]),
          "the int8 checkpoint has no residual sidecar")
    return {"fused": fused, "mesh_int8": mesh}


# -- the closed loop, the open-world population, the concurrency estimator ---
def _sr_run(torch, rounds: int, depth: int = 1, setup=None, **kw):
    """``build_engine(task="sr", **kw)`` at the published widths, ``rounds``
    rounds at ``depth`` with the launch counts zeroed just before and read
    just after (``setup(engine)`` runs before that)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_engine
    eng = build_engine(task="sr", pipeline_depth=depth, **kw)
    if setup is not None:
        setup(eng)
    ops.reset_launch_counts()
    res = eng.run(rounds)
    launches = ops.launch_counts()
    torch.cuda.synchronize()
    return eng, res, launches


def _round_rows(phase: str, res, **tags) -> None:
    for r in res:
        emit({"phase": phase, **tags, "round": r.round_idx, "loss": r.loss,
              "s_steps": r.s_steps, "exec_time": r.exec_time,
              "wall_time": r.wall_time, "pack_time": r.pack_time,
              "barrier_stall_s": r.barrier_stall_s,
              "drift_fallback": r.drift_fallback,
              "critical_path": r.critical_path})


def _model_rows(eng) -> int:
    return sum(len(m._xs) for m in eng.placement.models.values())


def phase_control(torch) -> dict:
    """The closed loop on SR at its published widths (K1 folding every
    lane-loop step):

    1. measured telemetry on the fused path at depths 0/1/2 under
       ``reuse`` and ``stall``, ``CONTROL_ROUNDS`` rounds each: the audit
       is clean, ``stall`` stalls nothing at depth <= 1, the LB model holds
       rows whose times came from the card (and the synthetic telemetry
       drew nothing), K1 launched once per lane-loop step — counted, and
       in a profiled round from the profiler's kernel events;
    2. measured telemetry on the mesh path (4 workers over 2 shards, flat,
       then tree with int8 uploads): per-worker times recorded exactly,
       none attributed by share, every worker with a residual, the audit
       clean, K2 twice a round with int8;
    3. synthetic telemetry with ``drift_threshold`` and ``adapt_interval``
       live at depths 0/1/2: losses bitwise, the fallback engaged, slot
       moves reached the worker pool."""
    from repro_torch.core import SyntheticTelemetry
    out = {"measured": {}, "mesh": {}, "synthetic": {}}
    for policy in ("reuse", "stall"):
        for depth in (0, 1, 2):
            eng, res, launches = _sr_run(torch, CONTROL_ROUNDS, depth,
                                         telemetry_mode="measured",
                                         barrier_policy=policy)
            _round_rows("control_measured", res, depth=depth, policy=policy)
            st = eng.control_stats
            steps = sum(r.s_steps for r in res)
            stall = [r.barrier_stall_s for r in res]
            check(eng.control.audit() == [] and st["audit_violations"] == 0,
                  f"measured {policy} depth {depth}: audit "
                  f"{eng.control.audit()}")
            if policy == "stall" and depth <= 1:
                check(all(x == 0.0 for x in stall),
                      f"stall at depth {depth} stalled: {stall}")
            check(st["barrier"]["rows_attributed"] > 0
                  and _model_rows(eng) > 0
                  and eng.placement.ready_for(eng.pool.snapshot()),
                  f"measured {policy} depth {depth}: the LB model holds no "
                  f"card rows: {st['barrier']}")
            check(eng.telemetry.state_dict()
                  == SyntheticTelemetry(seed=1337).state_dict(),
                  "measured mode drew synthetic telemetry")
            check(launches["fedavg_accum"] == steps > 0,
                  f"measured {policy} depth {depth}: K1 launched "
                  f"{launches['fedavg_accum']} times for {steps} steps")
            row = {"launches": launches["fedavg_accum"], "steps": steps,
                   "stall_s": sum(stall), "stalls": st["barrier"]["stalls"],
                   "model_rows": _model_rows(eng),
                   "rows_attributed": st["barrier"]["rows_attributed"],
                   "mean_exec_s": sum(r.exec_time for r in res[1:])
                   / (len(res) - 1),
                   "mean_wall_s": sum(r.wall_time for r in res[1:])
                   / (len(res) - 1),
                   "critical_path": [r.critical_path for r in res]}
            if policy == "reuse" and depth == 1:
                before = len(eng.history)
                prof = _device_profile(torch, lambda: eng.run(1),
                                       label="k1", match="fedavg", top=6)
                r = eng.history[before]
                check(prof["k1_launches"] == r.s_steps,
                      f"profiled measured round: {prof['k1_launches']} K1 "
                      f"kernels for {r.s_steps} steps")
                row["profile"] = prof
                check(eng.control.audit() == [], "audit after the profile")
            out["measured"][f"{policy}_depth{depth}"] = row
            emit({"phase": "control_measured_summary", "policy": policy,
                  "depth": depth, **row, "barrier": st["barrier"]})
    for label, kw in (("flat", dict(workers=4, mesh_workers=2)),
                      ("tree_int8", MESH)):
        eng, res, launches = _sr_run(torch, MESH_ROUNDS + 1, 1,
                                     telemetry_mode="measured", **kw)
        _round_rows("control_mesh", res, combine=label)
        st = eng.control_stats
        check(st["barrier"]["rows_attributed"] == 0
              and st["barrier"]["rows_exact"] > 0,
              f"mesh {label}: worker times not exact: {st['barrier']}")
        check(sorted(st["worker_residuals"]) == [0, 1, 2, 3],
              f"mesh {label}: residuals {st.get('worker_residuals')}")
        check(st["audit_violations"] == 0 and eng.control.audit() == [],
              f"mesh {label}: audit {eng.control.audit()}")
        if label == "tree_int8":
            check(launches["dequant_merge"] == 2 * len(res),
                  f"mesh int8: K2 launched {launches}")
        out["mesh"][label] = {
            "rows_exact": st["barrier"]["rows_exact"],
            "worker_residuals": st["worker_residuals"],
            "launches": launches,
            "mean_exec_s": sum(r.exec_time for r in res[1:]) / (len(res) - 1)}
        emit({"phase": "control_mesh_summary", "combine": label,
              **out["mesh"][label]})
    runs = {}
    for depth in (0, 1, 2):
        moves = []

        def spy(eng):
            # Record the pool's slot counts after every move the hill
            # climber applies (producer-side, in round order).
            apply = eng.control._apply_slots

            def applied(key, slots):
                apply(key, slots)
                moves.append((key, slots, sorted(
                    w.concurrency for w in eng.pool.workers.values())))

            eng.control._apply_slots = applied

        eng, res, launches = _sr_run(torch, CONTROL_ROUNDS, depth, spy,
                                     drift_threshold=CONTROL_DRIFT,
                                     adapt_interval=CONTROL_ADAPT)
        _round_rows("control_synthetic", res, depth=depth)
        slots = {w.wid: w.concurrency for w in eng.pool.snapshot()}
        check(eng.control.autoconc.updates > 0 and moves
              and all(set(pool) == {n} for _, n, pool in moves),
              f"synthetic depth {depth}: slot moves {moves} did not reach "
              f"the pool")
        check(launches["fedavg_accum"] == sum(r.s_steps for r in res),
              f"synthetic depth {depth}: K1 launched {launches}")
        runs[depth] = [(r.loss, r.drift_fallback, r.makespan) for r in res]
        out["synthetic"][f"depth{depth}"] = {
            "slots": slots, "moves": moves, "stats": eng.control_stats}
    check(runs[0] == runs[1] == runs[2],
          f"synthetic control: depths differ: {runs}")
    check(any(f for _, f, _ in runs[0]), "the drift fallback never engaged")
    out["synthetic"]["losses"] = [x[0] for x in runs[0]]
    emit({"phase": "control_summary", "bit_identical_depth_0_1_2": True,
          **out["synthetic"]})
    return out


def phase_population(torch) -> dict:
    """``build_engine(task="sr", sampler="online", population=1,000,000,
    cohort=64)`` with a global ``--population-outage`` window, at the
    published widths, ``POP_ROUNDS`` rounds at depths 0/1/2 with the
    controller live (drift fallback and hill climber): the SLO fields and
    losses identical across depths, ``stale_fraction`` > 0 only inside the
    window, O(cohort) probes a round and the prep time at 1 M clients;
    then a resume from a checkpoint replays the stream (cohorts, SLO
    fields, losses) bitwise with the controller state restored."""
    import tempfile
    from repro_torch.launch.train import build_engine
    kw = dict(sampler="online", population=POP_CLIENTS, cohort=POP_COHORT,
              population_outage=POP_OUTAGE, drift_threshold=CONTROL_DRIFT,
              adapt_interval=CONTROL_ADAPT)
    lo, hi = (int(x) for x in POP_OUTAGE.split(":"))
    runs, results = {}, {}
    for depth in (0, 1, 2):
        eng, res, launches = _sr_run(torch, POP_ROUNDS, depth, **kw)
        results[depth] = res
        _round_rows("population", res, depth=depth)
        for r in res:
            emit({"phase": "population_slo", "depth": depth,
                  "round": r.round_idx, "slo_p50": r.slo_p50,
                  "slo_p99": r.slo_p99, "stale_fraction": r.stale_fraction,
                  "online_pool": r.online_pool, "n_clients": r.n_clients})
        check(launches["fedavg_accum"] == sum(r.s_steps for r in res),
              f"population depth {depth}: K1 launched {launches}")
        probes = eng.sampler.index.probes
        check(probes <= POP_ROUNDS * 2 * eng.sampler.max_draw_factor
              * POP_COHORT, f"population: {probes} probes")
        runs[depth] = {
            "slo": [(r.slo_p50, r.slo_p99, r.stale_fraction, r.online_pool)
                    for r in res],
            "losses": [r.loss for r in res],
            "pack_time": [r.pack_time for r in res],
            "exec_time": [r.exec_time for r in res],
            "probes_per_round": probes / POP_ROUNDS,
            "launches": launches["fedavg_accum"]}
    slo = runs[0]["slo"]
    check(runs[0]["slo"] == runs[1]["slo"] == runs[2]["slo"],
          f"SLO fields differ across depths: {runs}")
    check(runs[0]["losses"] == runs[1]["losses"] == runs[2]["losses"],
          "population losses differ across depths")
    check(all((s[2] > 0) == (lo <= t < hi) for t, s in enumerate(slo)),
          f"stale_fraction outside/inside the outage {POP_OUTAGE}: {slo}")
    check(all(math.isfinite(x) for x in runs[0]["losses"]), "losses")
    whole = results[1]                   # depth 1, as build_engine's default
    with tempfile.TemporaryDirectory() as tmp:
        first = build_engine(task="sr", ckpt_dir=tmp,
                             rounds_per_checkpoint=POP_RESUME_AT // 2, **kw)
        first.run(POP_RESUME_AT)
        saved = first._control_ckpt_state
        eng = build_engine(task="sr", ckpt_dir=tmp, **kw)
        check(eng.restore_latest() and eng.round_idx == POP_RESUME_AT,
              f"population resume at {eng.round_idx}")
        check(eng.control.state_dict() == json.loads(json.dumps(saved)),
              "the restored controller state differs from the snapshot")
        resumed = eng.run(2)

    def sig(r):
        return (r.loss, r.n_clients, r.slo_p50, r.slo_p99, r.stale_fraction,
                r.online_pool, r.drift_fallback)

    check([sig(r) for r in resumed] == [sig(r) for r in
                                        whole[POP_RESUME_AT:]],
          f"resumed online stream differs: {[sig(r) for r in resumed]} vs "
          f"{[sig(r) for r in whole[POP_RESUME_AT:]]}")
    out = {"population": POP_CLIENTS, "cohort": POP_COHORT,
           "outage": POP_OUTAGE, "slo": slo, "losses": runs[1]["losses"],
           "pack_time_depth0": runs[0]["pack_time"],
           "pack_time_depth1": runs[1]["pack_time"],
           "exec_time_depth1": runs[1]["exec_time"],
           "probes_per_round": runs[0]["probes_per_round"],
           "launches": runs[1]["launches"],
           "resume_bitwise": True, "bit_identical_depth_0_1_2": True}
    emit({"phase": "population_summary", **out})
    return out


def phase_memory_probe(torch) -> dict:
    """``round_memory_analysis`` (one lane-loop round at 1 and 2 lanes, the
    allocator's peak) for SR and MLM at their published sizes, and the slot
    estimate it gives for this card and for the default 80 GB spec; then
    one SR round at ``min(estimate, adapt_max_slots)`` lanes on one worker,
    whose peak must stay within the estimate's budget."""
    import gc
    from repro_torch.core import (DeviceSpec,
                                  estimate_slots_from_memory_analysis,
                                  round_memory_analysis)
    from repro_torch.launch.train import build_engine
    card = DeviceSpec.from_card()
    out = {"card": {"name": card.name, "hbm_bytes": card.hbm_bytes}}
    card_est = {}
    for task in ("sr", "mlm"):
        eng = build_engine(task=task)
        probes = {n: round_memory_analysis(eng, slots_compiled=n)
                  for n in (1, 2)}
        est = {spec_name: estimate_slots_from_memory_analysis(
            probes[2], slots_compiled=2, group_devices=1, device=spec)
            for spec_name, spec in (("card", card),
                                    ("spec_80gb", DeviceSpec()))}
        card_est[task] = est["card"]
        check(probes[2].temp_size_in_bytes > probes[1].temp_size_in_bytes,
              f"{task}: 2 lanes took no more temp bytes than 1: {probes}")
        out[task] = {"probe": {n: vars(m) for n, m in probes.items()},
                     "estimate": {k: vars(e) for k, e in est.items()}}
        emit({"phase": "memory_probe", "task": task, "card": out["card"],
              **out[task]})
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    est = card_est["sr"]
    lanes = min(est.slots, CONTROL_MAX_SLOTS)
    eng = build_engine(task="sr", workers=1, concurrency=lanes,
                       cohort=lanes)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = eng.run(1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(res[0].loss), f"{lanes}-lane SR round: {res}")
    check(peak <= est.budget_bytes,
          f"{lanes}-lane SR round peaked at {peak} B, over the estimate's "
          f"budget {est.budget_bytes} B")
    out["sr_round"] = {"lanes": lanes, "peak_bytes": peak,
                       "budget_bytes": est.budget_bytes,
                       "estimate_slots": est.slots,
                       "exec_time": res[0].exec_time,
                       "s_steps": res[0].s_steps}
    emit({"phase": "memory_probe_round", **out["sr_round"]})
    return out


def _small_task_engine(task: str, device: str):
    """A reduced task engine (the CPU tests' widths; cohort 8 over 2
    workers x 2 lanes, ``steps_cap`` 2) with the task's reference
    optimizer."""
    from repro_torch.core import (EngineConfig, FederatedEngine,
                                  SyntheticTelemetry, UniformSampler,
                                  make_placement)
    from repro_torch.data import make_federated_dataset
    from repro_torch.distributed import WorkerPool
    from repro_torch.models.papertasks import make_task_model
    from repro_torch.optim import adam, sgd
    small = TASK_SMALL[task]
    extra = ({"vocab_size": small["vocab"], "seq_len": 12}
             if task != "ic" else {})
    ds = make_federated_dataset(task, n_clients=64, batch_size=4,
                                size_mu=2.5, size_sigma=0.8, **extra)
    params, loss = make_task_model(task, 0, device="cpu", **small)
    opt = (adam(4e-5) if task == "mlm" else
           sgd(0.8 if task == "tg" else 0.05, momentum=0.9,
               weight_decay=5e-4))
    return FederatedEngine(
        dataset=ds, loss_fn=loss, init_params=params, optimizer=opt,
        placement=make_placement("lb"), sampler=UniformSampler(64, 8),
        pool=WorkerPool.homogeneous(2, type_name="a40", concurrency=2),
        telemetry=SyntheticTelemetry(),
        config=EngineConfig(steps_cap=2, batch_size=4, lanes_per_worker=2),
        device=device)


def phase_agree_tasks(torch) -> dict:
    """Reduced IC, TG and MLM engines, 2 rounds on the card against the
    same on the CPU: losses within ``AGREE_TASKS_RTOL``."""
    out = {}
    for task in ("ic", "tg", "mlm"):
        losses = {dev: [r.loss for r in
                        _small_task_engine(task, dev).run(2)]
                  for dev in ("cpu", "cuda")}
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
        emit({"phase": "agree_tasks", "task": task, "losses": losses,
              "max_rel_diff": rel, "rtol": AGREE_TASKS_RTOL})
        check(rel <= AGREE_TASKS_RTOL,
              f"{task}: card vs CPU losses differ by {rel}: {losses}")
        out[task] = rel
    return out


# -- the device batch cache and the process-per-host harness (PR 22) ---------
def _cache_spy(torch, eng, timed: bool) -> tuple[list, list]:
    """Record every cache plan the producer makes; with ``timed``, the host
    seconds of each assembly on the consumer thread and CUDA events around
    it on the stream (the stream's time from the first enqueued op to the
    last: mostly the host's enqueueing, as the stream is idle then)."""
    cache = eng._device_cache
    plans, spans = [], []
    plan, apply = cache.plan, cache.apply

    def planned(*a, **kw):
        cp = plan(*a, **kw)
        plans.append(cp)
        return cp

    def applied(miss, cp):
        if not timed:
            return apply(miss, cp)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        out = apply(miss, cp)
        ev[1].record()
        spans.append((cp.round_idx, ev, time.perf_counter() - t0))
        return out

    cache.plan, cache.apply = planned, applied
    return plans, spans


def _h2d_bytes(lanes: int, S: int, content_rows: int, n_index: int) -> int:
    """Bytes a fused round copies to the card: the content rows, the three
    ``[W, P, S]`` f32 masks, and the cache's int64 index vectors."""
    return content_rows * SR_ROW_BYTES + 3 * 4 * lanes * S + 8 * n_index


def _per_shard_sums(st: dict) -> bool:
    return all(sum(s[k] for s in st["per_shard"]) == st[k]
               for k in ("hit_steps", "miss_steps", "insertions",
                         "evictions", "reclaim_evictions", "bytes_saved"))


def phase_cache(torch) -> dict:
    """The device batch cache on the fused path: ``build_engine(task="sr",
    sampler="zipf", grad_clip=1.0, cohort=64)`` at the published widths,
    ``CACHE_ROUNDS`` rounds with the cache off (depth 1), with
    ``CACHE_ROWS`` rows and with a byte budget that holds the whole
    population, each at depths 0/1/2:
    losses bitwise equal to the cache-off run, K1 = Σ ``s_steps``,
    ``bytes_saved == hit_steps × 5,200``, no eviction under the population
    budget.  Records the hit rate, ``pack_time`` and the bytes copied to
    the card a round with the cache on and off, the assembly's device ms a
    round (CUDA events) and a profiled round."""
    from repro_torch.core.engine import _probe_row_bytes
    from repro_torch.data import make_federated_dataset
    ds = make_federated_dataset("sr", seed=1337)
    row_bytes = _probe_row_bytes(ds, batch_size=20)
    check(row_bytes == SR_ROW_BYTES, f"SR batch row is {row_bytes} B")
    pop_batches = sum(ds.n_batches(c) for c in range(ds.n_clients))
    kw = dict(CACHE_KW, cohort=CACHE_COHORT)
    lanes = 4                                  # 2 workers x 2 lanes
    _, off, k_off = _sr_run(torch, CACHE_ROUNDS, 1, **kw)
    ref = [r.loss for r in off]
    check(all(math.isfinite(x) for x in ref), f"cache off: losses {ref}")
    check(k_off["fedavg_accum"] == sum(r.s_steps for r in off),
          f"cache off: K1 launched {k_off}")
    off_bytes = [_h2d_bytes(lanes, r.s_steps, lanes * r.s_steps, 0)
                 for r in off]
    out = {"row_bytes": row_bytes, "population_batches": pop_batches,
           "off": {"launches": k_off["fedavg_accum"], "h2d_bytes": off_bytes,
                   "pack_s": [r.pack_time for r in off],
                   "exec_s": [r.exec_time for r in off]}}
    emit({"phase": "cache_summary", "setting": "off", "depth": 1,
          "losses": ref, **out["off"]})
    settings = {"rows512": dict(device_cache_batches=CACHE_ROWS),
                "population": dict(device_cache_bytes=pop_batches
                                   * row_bytes)}
    for label, extra in settings.items():
        for depth in (0, 1, 2):
            spy = {}

            def setup(eng, depth=depth):
                spy["plans"], spy["spans"] = _cache_spy(torch, eng,
                                                        depth == 1)

            eng, res, k = _sr_run(torch, CACHE_ROUNDS, depth, setup,
                                  **kw, **extra)
            losses = [r.loss for r in res]
            check(losses == ref, f"cache {label} depth {depth}: losses "
                                 f"{losses} != cache off {ref}")
            steps = sum(r.s_steps for r in res)
            check(k["fedavg_accum"] == steps,
                  f"cache {label} depth {depth}: K1 {k} for {steps} steps")
            st = eng.cache_stats
            check(st["bytes_saved"] == st["hit_steps"] * row_bytes
                  == sum(r.cache_bytes_saved for r in res),
                  f"cache {label} depth {depth}: bytes saved {st}")
            check(st["hit_steps"] > 0, f"cache {label}: no hit in {st}")
            if label == "population":
                check(st["capacity_rows"] == pop_batches
                      and st["evictions"] == 0,
                      f"population budget: {st['capacity_rows']} rows, "
                      f"{st['evictions']} evictions")
            plans = {cp.round_idx: cp for cp in spy["plans"]}
            on_bytes = [_h2d_bytes(
                lanes, r.s_steps, plans[r.round_idx].n_miss_rows,
                sum(getattr(plans[r.round_idx], f).size for f in (
                    "miss_dst", "ins_src", "ins_dst", "hit_src",
                    "hit_dst"))) for r in res]
            for r, b in zip(res, on_bytes):
                emit({"phase": "cache", "setting": label, "depth": depth,
                      "round": r.round_idx, "loss": r.loss,
                      "hit_rate": r.cache_hit_rate,
                      "bytes_saved": r.cache_bytes_saved, "h2d_bytes": b,
                      "h2d_bytes_off": off_bytes[r.round_idx],
                      "s_steps": r.s_steps, "pack_time": r.pack_time,
                      "exec_time": r.exec_time, "wall_time": r.wall_time})
            row = {"launches": k["fedavg_accum"], "steps": steps,
                   "hit_rate": [r.cache_hit_rate for r in res],
                   "h2d_bytes": on_bytes,
                   "pack_s": [r.pack_time for r in res],
                   "exec_s": [r.exec_time for r in res],
                   "stats": {k2: v for k2, v in st.items()
                             if k2 != "per_shard"}}
            if depth == 1:
                torch.cuda.synchronize()
                row["assembly_stream_ms"] = [ev[0].elapsed_time(ev[1])
                                             for _, ev, _ in spy["spans"]]
                row["assembly_host_ms"] = [h * 1e3
                                           for _, _, h in spy["spans"]]
                prof = _device_profile(
                    torch, lambda: eng.run(1), label="k1", match="fedavg",
                    top=8, groups={"assembly": ("index", "adix", "ort")})
                r = eng.history[-1]
                check(prof["k1_launches"] == r.s_steps,
                      f"profiled cache round: {prof['k1_launches']} K1 "
                      f"kernels for {r.s_steps} steps")
                row["profile"] = {**prof, "hit_rate": r.cache_hit_rate}
            out[f"{label}_depth{depth}"] = row
            emit({"phase": "cache_summary", "setting": label, "depth": depth,
                  **row})
    return out


def _small_mesh_engine(device: str, **cfg):
    """The agree phase's small SR engine (width 64, 2 blocks, 64 clients,
    SGD 0.05) on 4 workers x 2 lanes over 2 mesh shards with a Zipf draw of
    8, and ``cfg`` for the rest of its config."""
    from repro_torch.core import (EngineConfig, FederatedEngine,
                                  SyntheticTelemetry, ZipfSampler,
                                  make_placement)
    from repro_torch.data import make_federated_dataset
    from repro_torch.distributed import WorkerPool
    from repro_torch.models.papertasks import make_task_model
    from repro_torch.optim import sgd
    ds = make_federated_dataset("sr", n_clients=64, batch_size=4,
                                size_mu=2.5, size_sigma=0.8)
    params, loss = make_task_model("sr", 0, width=64, n_blocks=2,
                                   device="cpu")
    return FederatedEngine(
        dataset=ds, loss_fn=loss, init_params=params,
        optimizer=sgd(0.05, momentum=0.9, weight_decay=5e-4),
        placement=make_placement("lb"), sampler=ZipfSampler(64, 8, a=1.2),
        pool=WorkerPool.homogeneous(4, type_name="a40", concurrency=2),
        telemetry=SyntheticTelemetry(),
        config=EngineConfig(steps_cap=4, batch_size=4, lanes_per_worker=2,
                            mesh_workers=2, **cfg),
        device=device)


def _agree_cache_mesh(torch) -> dict:
    """The cache mesh's options (tree, int8, cache, affinity, clip) on the
    small engine, 6 rounds on the card and on the CPU: losses within the
    agree phase's rtol 1e-4, hits and affinity swaps equal."""
    cfg = dict(combine_mode="tree", combine_compress="int8",
               device_cache_batches=64, cache_affinity=True, grad_clip=1.0)
    runs = {dev: _small_mesh_engine(dev, **cfg).run(6)
            for dev in ("cpu", "cuda")}
    losses = {dev: [r.loss for r in res] for dev, res in runs.items()}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    check(rel <= 1e-4, f"cache mesh card vs CPU: {rel} ({losses})")
    for f in ("cache_hit_rate", "affinity_swaps"):
        check([getattr(r, f) for r in runs["cuda"]]
              == [getattr(r, f) for r in runs["cpu"]],
              f"cache mesh card vs CPU: {f} differs")
    return {"losses": losses, "max_rel_diff": rel, "rtol": 1e-4,
            "affinity_swaps": [r.affinity_swaps for r in runs["cuda"]],
            "hit_rate": [r.cache_hit_rate for r in runs["cuda"]]}


def _reclaim_on_card(torch) -> dict:
    """``tests/test_reclaim.py:215`` on the card: shard 1 (wids 1, 3) loses
    both workers at round 3 and wid 5 rejoins it at round 7; the capacity
    rows go [32, 32] → [64, 0] → [32, 32] in 2 rebalances, the per-shard
    counters sum to the global ones, affinity never routes to the dead
    shard, the audit stays clean."""
    from repro_torch.core import (EngineConfig, FederatedEngine,
                                  SyntheticTelemetry, ZipfSampler,
                                  make_placement)
    from repro_torch.data import make_federated_dataset
    from repro_torch.distributed import FailureEvent, WorkerPool
    from repro_torch.models.papertasks import make_task_model
    from repro_torch.optim import sgd
    ds = make_federated_dataset("sr", n_clients=64, input_dim=16,
                                batch_size=4, size_mu=2.5, size_sigma=0.8)
    params, loss = make_task_model("sr", 0, device="cpu", input_dim=16,
                                   width=32, n_blocks=2)
    pool = WorkerPool.homogeneous(4, type_name="a40", concurrency=2)
    for ev in (FailureEvent(round_idx=3, kind="fail", wid=1),
               FailureEvent(round_idx=3, kind="fail", wid=3),
               FailureEvent(round_idx=7, kind="join", wid=5,
                            type_name="a40", concurrency=2)):
        pool.schedule(ev)
    eng = FederatedEngine(
        dataset=ds, loss_fn=loss, init_params=params,
        optimizer=sgd(0.1, momentum=0.9), placement=make_placement("lb"),
        sampler=ZipfSampler(64, 8, a=1.2), pool=pool,
        telemetry=SyntheticTelemetry(),
        config=EngineConfig(steps_cap=4, batch_size=4, lanes_per_worker=2,
                            pipeline_depth=1, mesh_workers=2,
                            device_cache_batches=64, cache_affinity=True,
                            telemetry_mode="measured", drift_threshold=0.4),
        device="cuda")
    caps = []
    for n in (3, 3, 1, 2, 2):
        eng.run(n)
        st = eng.cache_stats
        caps.append([s["capacity_rows"] for s in st["per_shard"]])
        check(_per_shard_sums(st), f"reclaim: per-shard sums {st}")
        if len(caps) == 3:
            check(st["per_shard"][1]["clients_cached"] == 0,
                  "reclaim: the dead shard holds entries")
    check(caps[:4] == [[32, 32], [64, 0], [64, 0], [32, 32]],
          f"reclaim: capacity rows {caps}")
    check(st["rebalances"] == 2 and st["rows_moved"] == 64,
          f"reclaim: {st['rebalances']} rebalances, {st['rows_moved']} rows")
    cst = eng.control.stats()
    check(cst["cache_rebalances"] == 2 and cst["audit_violations"] == 0,
          f"reclaim: control {cst['cache_rebalances']} rebalances, audit "
          f"{cst['audit_violations']}")
    check(all(math.isfinite(r.loss) for r in eng.history),
          "reclaim: non-finite losses")
    return {"capacity_rows": caps, "rebalances": st["rebalances"],
            "rows_moved": st["rows_moved"]}


def phase_cache_mesh(torch) -> dict:
    """The cache on the mesh path: ``CACHE_MESH`` (4 workers over 2 shards,
    tree, int8, 256 rows, cache affinity) at the published widths,
    ``CACHE_MESH_ROUNDS`` rounds at depths 1 and 0 (bitwise), per-shard
    counters summing to the global ones, K2 once per live shard a round,
    K1 once per worker-program step; the same mesh without affinity is
    bitwise cache-off; its first rounds card vs CPU recorded; the same
    options on the agree phase's small engine, card vs CPU within its rtol
    1e-4; then the reclaim scenario."""
    from repro_torch.launch.train import build_engine
    runs, out = {}, {}
    for depth in (1, 0):
        eng, res, k = _sr_run(torch, CACHE_MESH_ROUNDS, depth, **CACHE_MESH)
        _round_rows("cache_mesh", res, depth=depth)
        st = eng.cache_stats
        check(_per_shard_sums(st), f"cache mesh: per-shard sums {st}")
        check(k["dequant_merge"] == CACHE_MESH["mesh_workers"] * len(res),
              f"cache mesh depth {depth}: K2 launched {k}")
        steps = CACHE_MESH["workers"] * sum(r.s_steps for r in res)
        check(k["fedavg_accum"] == steps,
              f"cache mesh depth {depth}: K1 {k} for {steps} steps")
        runs[depth] = [r.loss for r in res]
        out[f"depth{depth}"] = {
            "launches": k, "hit_rate": [r.cache_hit_rate for r in res],
            "affinity_swaps": [r.affinity_swaps for r in res],
            "exec_s": [r.exec_time for r in res],
            "pack_s": [r.pack_time for r in res],
            "per_shard": st["per_shard"]}
    check(runs[1] == runs[0], f"cache mesh: depths differ {runs}")
    check(all(math.isfinite(x) for x in runs[1]), f"cache mesh: {runs}")
    plain = dict(MESH, **CACHE_KW)
    on = _sr_run(torch, CACHE_MESH_ROUNDS, 1, device_cache_batches=256,
                 **plain)[1]
    off = _sr_run(torch, CACHE_MESH_ROUNDS, 1, **plain)[1]
    check([r.loss for r in on] == [r.loss for r in off],
          "cache mesh without affinity: cache on != off")
    cpu = [r.loss for r in build_engine(task="sr", device="cpu",
                                        **CACHE_MESH).run(CACHE_AGREE_ROUNDS)]
    out["published_card_vs_cpu"] = {
        "cpu": cpu, "rel_diff": [abs(a - b) / abs(b)
                                 for a, b in zip(runs[1], cpu)]}
    out["agree"] = _agree_cache_mesh(torch)
    out["reclaim"] = _reclaim_on_card(torch)
    emit({"phase": "cache_mesh_summary", "losses": runs[1],
          "bit_identical_depth_0_1": True, **out})
    return out


def phase_multihost(torch) -> dict:
    """The process-per-host harness on the card: ``run_multihost(
    build_engine, MULTIHOST, hosts=2)`` — two spawned ranks sharing the
    card — bitwise equal to the in-process ``hosts=1`` run, every rank
    agreeing and running only its own block's workers, the sidecar audit
    clean; then rank 1 killed inside round 3's exchange (``ok=False``, a
    flight dump) and a fleet resumed from rank 0's checkpoint bitwise equal
    to the uninterrupted run.  Records the wall time a round against the
    in-process run, and the exchange's ms and bytes a rank a round."""
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.launch.multihost import run_multihost
    from repro_torch.launch.train import build_engine
    from repro_torch.obs import make_observability
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_multihost(build_engine, MULTIHOST, hosts=2,
                        rounds=MULTIHOST_ROUNDS)
    fleet_s = time.perf_counter() - t0
    check(res.ok, f"multihost: {res.reason}")
    eng = build_engine(**dict(MULTIHOST, hosts=1))
    ops.reset_launch_counts()
    ref = eng.run(MULTIHOST_ROUNDS)
    launches = ops.launch_counts()
    torch.cuda.synchronize()
    check(res.losses == [r.loss for r in ref],
          f"multihost {res.losses} != in process {[r.loss for r in ref]}")
    steps = sum(r.s_steps for r in ref)
    check(launches["fedavg_accum"] == 4 * steps,
          f"multihost reference: K1 {launches}")
    # Each rank's own count over its run: K1 once a step for each of its
    # block's 2 workers, the two ranks together the in-process run's.
    rank_k1 = {h: res.per_rank_launches[h]["fedavg_accum"] for h in (0, 1)}
    check(rank_k1 == {0: 2 * steps, 1: 2 * steps},
          f"multihost: rank K1 {res.per_rank_launches} for {steps} steps")
    check(res.audit == [] and len(res.records) == 2 * MULTIHOST_ROUNDS,
          f"multihost: audit {res.audit}, {len(res.records)} records")
    for r in res.records:
        wids = {w[0] for w in r.worker_times}
        check(wids == ({0, 1} if r.host == 0 else {2, 3}),
              f"multihost: rank {r.host} ran workers {wids}")
    part_bytes = SR_PARAMS * 4 + 8
    check(all(b == [part_bytes, part_bytes] for b in res.exchange_bytes),
          f"multihost: exchanged {res.exchange_bytes} B")
    out = {"losses": res.losses, "fleet_wall_s": fleet_s,
           "rank_launches": res.per_rank_launches,
           "exchange_ms": [x * 1e3 for x in res.exchange_s],
           "exchange_bytes_per_rank": part_bytes,
           "rank_exec_s": {h: [r.exec_s for r in res.records
                               if r.host == h] for h in (0, 1)},
           "in_process_exec_s": [r.exec_time for r in ref],
           "in_process_wall_s": [r.wall_time for r in ref]}
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(MULTIHOST, ckpt_dir=f"{tmp}/ck", rounds_per_checkpoint=2)
        full_res = build_engine(**dict(kw, hosts=1, ckpt_dir=None)).run(6)
        full = [r.loss for r in full_res]
        back_steps = sum(r.s_steps for r in full_res[2:6])
        fpath = f"{tmp}/flight.json"
        obs = make_observability(trace_rounds=8, flight_rounds=8,
                                 flight_path=fpath)
        dead = run_multihost(build_engine, kw, hosts=2, rounds=6,
                             kill_at=(3, 1), flight=obs.flight)
        check(not dead.ok and "host 1 died" in dead.reason
              and dead.rounds_completed == 3 and dead.audit == [],
              f"multihost kill: ok={dead.ok} {dead.reason!r} "
              f"rounds={dead.rounds_completed}")
        check(dead.flight_path == fpath and os.path.exists(fpath),
              f"multihost kill: flight dump {dead.flight_path}")
        with open(fpath) as f:
            check("host 1 died" in json.load(f)["reason"],
                  "multihost kill: the flight dump's reason")
        back = run_multihost(build_engine, kw, hosts=2, rounds=4,
                             resume=True)
        check(back.ok and back.losses == full[2:6],
              f"multihost resume: {back.reason} {back.losses} != "
              f"{full[2:6]}")
        check({h: c["fedavg_accum"]
               for h, c in back.per_rank_launches.items()}
              == {0: 2 * back_steps, 1: 2 * back_steps},
              f"multihost resume: rank K1 {back.per_rank_launches} for "
              f"{back_steps} steps")
    out["kill"] = {"reason": dead.reason.splitlines()[0],
                   "rounds_completed": dead.rounds_completed,
                   "resumed_losses": back.losses}
    emit({"phase": "multihost_summary", "bit_identical_hosts_1_2": True,
          **out})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--profile-out", default=None)
    args = ap.parse_args()

    import torch
    from repro_torch.launch.train import set_deterministic
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    set_deterministic()
    smi = phase_probe(torch)
    sass, sass5 = phase_build()
    name = torch.cuda.get_device_name(0)
    lanes, n_params = 4, SR_PARAMS       # 2 workers x 2 lanes, SR published
    max_err = phase_check(torch, n_params, lanes)
    layout = _sr_layout()
    max_err2 = phase_check_k2(torch, layout)
    err3 = phase_check_k3(torch)
    err4 = phase_check_k4(torch)
    err5 = phase_check_k5(torch)
    timing = phase_timing(torch, n_params, lanes, name)
    timing2 = phase_timing_k2(torch, layout, name)
    timing3 = phase_timing_k3(torch, name)
    timing4 = phase_timing_k4(torch, name)
    timing4_moe = phase_timing_k4(torch, name, _moe_cfg())
    timing4_vlm = phase_timing_k4(torch, name, _vlm_cfg(),
                                  _vlm_positions(_vlm_cfg()))
    timing5 = phase_timing_k5(torch, name)
    launches, steps, res = phase_main(torch, args.rounds)
    mesh_launches, mesh_res = phase_mesh(torch, MESH_ROUNDS)
    phase_decomposition(torch)
    phase_agree(torch)
    serve = phase_serve(torch)
    phase_serve_profile(torch, serve)
    del serve["params"]
    phase_agree_lm(torch, SERVE_ARCH, attn_impl="pallas")
    ssm = phase_serve_ssm(torch)
    phase_serve_profile(torch, ssm, _ssm_cfg(), label="k5", match="ssd_fwd",
                        phase="serve_ssm_profile")
    del ssm["params"]
    phase_agree_lm(torch, SSM_ARCH, ssd_impl="pallas")
    moe = phase_serve_moe(torch)
    phase_serve_profile(torch, moe, _moe_cfg(), phase="serve_moe_profile",
                        groups=MOE_DISPATCH_KERNELS)
    del moe["params"]
    for arch, impl in ((MOE_ARCH, {}), ("qwen3-moe-235b-a22b", {}),
                       ("jamba-v0.1-52b", {"ssd_impl": "pallas"})):
        phase_agree_lm(torch, arch, attn_impl="pallas", **impl)
    audio = phase_serve_audio(torch)
    phase_serve_profile(torch, audio, _audio_cfg(),
                        phase="serve_audio_profile")
    del audio["params"]
    phase_agree_lm(torch, AUDIO_ARCH)
    vlm = phase_serve_vlm(torch)
    phase_serve_profile(torch, vlm, _vlm_cfg(), phase="serve_vlm_profile")
    del vlm["params"]
    torch.cuda.empty_cache()
    phase_agree_lm(torch, VLM_ARCH, attn_impl="pallas")
    train_lm = phase_train_lm(torch)
    train_mesh = phase_train_lm_mesh(torch)
    torch.cuda.empty_cache()
    train_full = phase_train_full(torch)
    lm_fold = phase_lm_fold(torch, name)
    k2_lm = phase_k2_lm(torch, name)
    phase_agree_train(torch)
    tasks = phase_train_tasks(torch, name)
    fedmedian = phase_fedmedian(torch)
    resume = phase_resume(torch)
    phase_agree_tasks(torch)
    control = phase_control(torch)
    population = phase_population(torch)
    memory = phase_memory_probe(torch)
    cache = phase_cache(torch)
    cache_mesh = phase_cache_mesh(torch)
    multihost = phase_multihost(torch)
    if args.profile_out:
        phase_profile(torch, args.profile_out, "fused")
        phase_profile(torch, args.profile_out, "mesh", **MESH)

    def row(kernel, src, replaces, n, err, t):
        return {"name": kernel, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    emit({"kernels": [
        {**row("fedavg_accum", "fedavg_accum.cu",
               "src/repro/kernels/fedavg_accum.py:41", launches, max_err,
               timing),
         "launches_per_round": launches / len(res),
         "launches_mesh_path": mesh_launches["fedavg_accum"],
         "launches_train_lm": {a: v["launches"]
                               for a, v in train_lm.items()},
         "launches_train_lm_mesh": train_mesh["launches"]["fedavg_accum"],
         "launches_train_full": train_full["launches"],
         "launches_train_tasks": {t: v["launches"] for t, v in tasks.items()},
         "train_tasks_fold": {t: v["fold"] for t, v in tasks.items()},
         "launches_fedmedian": fedmedian["launches_depth1"]["fedavg_accum"],
         "launches_resume_fused": resume["fused"]["launches_resumed"][
             "fedavg_accum"],
         "launches_control_measured": {
             k: v["launches"] for k, v in control["measured"].items()},
         "launches_control_mesh": {
             k: v["launches"]["fedavg_accum"]
             for k, v in control["mesh"].items()},
         "launches_population": population["launches"],
         "launches_cache": {k: v["launches"] for k, v in cache.items()
                            if isinstance(v, dict) and "launches" in v},
         "launches_cache_mesh": cache_mesh["depth1"]["launches"][
             "fedavg_accum"],
         "launches_multihost_per_rank": {
             h: c["fedavg_accum"]
             for h, c in multihost["rank_launches"].items()},
         "train_full_fold": {k: lm_fold[k] for k in (
             "shape", "ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by", "max_abs_err")}},
        {**row("dequant_merge", "dequant_merge.cu",
               "src/repro/kernels/dequant_merge.py:46",
               mesh_launches["dequant_merge"], max_err2, timing2),
         "launches_per_round": mesh_launches["dequant_merge"] / len(mesh_res),
         "launches_train_lm_mesh": train_mesh["launches"]["dequant_merge"],
         "launches_resume_mesh": resume["mesh_int8"]["launches_resumed"][
             "dequant_merge"],
         "launches_control_mesh": control["mesh"]["tree_int8"]["launches"][
             "dequant_merge"],
         "launches_cache_mesh": cache_mesh["depth1"]["launches"][
             "dequant_merge"],
         "lm_payload": {k: k2_lm[k] for k in (
             "shape", "leaves", "ms", "plain_ms", "bound_ms", "bound_by")},
         "path": "mesh"},
        {**row("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:30",
               serve["launches"]["rmsnorm"], max(err3.values()),
               timing3["norm_block"]),
         "norm_q": {k: timing3["norm_q"][k] for k in
                    ("shape", "ms", "plain_ms", "library_ms", "bound_ms")},
         "path": "serve (layers.rms_norm(impl='pallas') on the serve "
                 "path's norm inputs; the model keeps 'xla')"},
        {**row("flash_attention", "flash_attention.cu",
               "src/repro/kernels/flash_attention.py:89",
               serve["launches"]["flash_attention"], max(err4.values()),
               timing4),
         "launches_per_prefill": serve["launches"]["flash_attention"],
         "launches_by_route": serve["k4_routes_prefill"], "sass": sass,
         "launches_serve_moe": moe["launches"]["flash_attention"],
         "launches_by_route_serve_moe": moe["k4_routes_prefill"],
         "serve_moe_shape": {k: timing4_moe[k] for k in (
             "shape_q", "shape_kv", "ms", "plain_ms", "library_ms",
             "bound_ms", "bound_by")},
         "launches_serve_vlm": vlm["launches"]["flash_attention"],
         "launches_by_route_serve_vlm": vlm["k4_routes_prefill"],
         "serve_vlm_shape": {k: timing4_vlm[k] for k in (
             "shape_q", "shape_kv", "ms", "plain_ms", "library_ms",
             "bound_ms", "bound_by")},
         "path": "serve (qwen3-0.6b, granite-moe-3b-a800m and "
                 "internvl2-26b prefill, attn_impl='pallas')"},
        {**row("ssd", "ssd.cu", "src/repro/kernels/ssd.py:83",
               ssm["launches"]["ssd"], max(err5.values()), timing5),
         "launches_per_prefill": ssm["launches"]["ssd"],
         "launches_by_route": ssm["k5_routes_prefill"], "sass": sass5,
         "path": "serve SSM (mamba2-2.7b prefill, ssd_impl='pallas')"}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
