#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: the quickest proof that
the port still builds, agrees with itself, trains and serves on the GPU.

    python3 chip_smoke.py [--rounds 4] [--profile-out DIR] [--dryrun-out DIR]

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
             K4 at the qwen3, granite-moe, internvl2 and jamba serve
             shapes, 8e-3 in bf16),
             K4 also on its wgmma route's bf16 cases (d 64 and 128, ragged
             s and t, GQA groups 1-8, non-causal, fused q/k/v views), each
             case on the route its dtype and head dim name, and a
             misaligned bf16 input must raise;
             K5, y and the final state, over the reference's sweep in f32
             and bf16, at the mamba2 and jamba serve shapes and at a
             (1, 2) mesh rank's share of jamba's heads in f32 and
             bf16 and a 1,000-row prompt, and on its wgmma route's bf16 cases (p 64:
             chunks shorter than 128, GQA groups, n 16 and 40, a prompt
             shorter than a chunk), each case on the route its dtype and
             widths name (``SSD_TOL``);
4. timing  — each kernel, its plain version and, where one exists, one
             library call at the main paths' shapes (CUDA events, best of
             3 interleaved), beside the bytes/ops bound; K4 at the four
             serve shapes (qwen3: 16 heads of 128; granite-moe: 24 of 64,
             group 3; internvl2: 48 of 128 over 2,304 positions, group
             6; jamba: 32 of 128, group 4); K5 at mamba2's (80 heads,
             state 128), jamba's (128 heads, state 16) and a (1, 2) mesh
             rank's (64 of jamba's heads);
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
             ``launch.steps.device_params(cfg, 0)`` drawn on the card; with
             the launch counts zeroed just before
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
             with ``ssd_impl="pallas"``, its 2.7 B weights drawn on the
             card, the same traffic as phase 9, with
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
             depth in bf16 (3,299,182,080 params drawn on the card) with
             ``attn_impl="pallas"`` and
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
14b. serve hybrid — jamba-v0.1-52b at its published widths and dtypes cut
             to one 8-layer period (13,267,598,848 params drawn on the
             card: 7 Mamba-2 layers, 1 attention layer, 4 MoE layers of 16
             experts top-2, 14,336 wide) with ``attn_impl`` and
             ``ssd_impl`` ``"pallas"`` and ``moe_impl="scatter"``, the same
             traffic as phase 9, the launch counts zeroed just before and
             read just after: K4 exactly once and K5 exactly 7 times in the
             prefill, all on their wgmma routes, neither in decode; finite
             logits; the dropped-slot share at capacity 1.25; the pallas
             prefill against dense attention + the chunked SSD, a dropless
             prefill + decode against a dropless ``forward`` and a
             1,000-token prompt, in bf16 (``MOE_BF16_TOL``, prefill +
             decode at ``HYBRID_DECODE_BF16_TOL``, on tokens whose experts
             agree) and with the weights upcast to f32 on 2 of the prompts
             (``MOE_F32_TOL`` on tokens clear of near-ties), with the
             routing decisions that differ; a profiled prefill and decode
             step (idle share; K4's, K5's, the dispatch passes' and the
             GEMMs' shares); the prefill's allocator peak, broken down by
             where it was allocated (``_peak_breakdown``);
14b. serve hybrid mesh — the same 8-layer jamba split over a (data 1,
             model 2) mesh of 2 gloo ranks sharing the card (``launch.mesh
             .run_on_mesh``): each rank draws every leaf as phase 14 drew it
             and keeps its ``fsdp_tp`` shard (its parameter bytes must be
             the specs' arithmetic), the MoE layers go through the plan's
             ``make_ep_dispatch`` (8 of 16 experts a rank); one prefill of
             the same 4 x 2,048 tokens and ``MESH_DECODE`` greedy steps
             (into a cache of phase 14's length, ``SERVE_MAX_LEN``),
             the launch counts zeroed just before and read just after: K4
             once and K5 7 times a prefill on each rank, all wgmma, neither
             in decode, K5 at the rank's 64 heads (each Mamba mixer split
             by heads); each decode step's all-gathers over model no
             larger than one token's packed in-projection or query heads
             (no weight, no cache leaf: each rank attends over its half of
             the cache's slots, the flash-decode combine); each rank's
             counted wire bytes by collective kind beside its gloo time;
             logits and tokens against phase 14's run (a routed
             pass of it) at ``MOE_BF16_TOL`` (prefill) and
             ``HYBRID_DECODE_BF16_TOL`` (prefill + decode) on the tokens
             whose routes and kept slots agree in both runs; each rank's
             peak, its time in gloo collectives; ``make_ep_dispatch`` in
             f32 at one MoE layer's widths over the same 2 ranks against
             ``moe_layer_3d("scatter")`` (``MESH_EP_TOL``), and on a (1, 1)
             NCCL mesh bitwise;
14c. train sharded — the sharded training step: one federated round of
             the reference's train_4k plan on a mesh of gloo ranks sharing
             the card, at the published widths and dtypes, cut to 2 local
             steps of 2 sequences ((a): 1) of 4,096 tokens, one client a
             lane
             (``TRAIN_SHARDED_RUNS``): (a) qwen3-0.6b, ``tp`` on (data 2,
             model 2), two workers over data; (b) qwen3-moe-235b-a22b's
             plan for its 94 layers, the config cut to 1 layer,
             ``fsdp_tp`` on (data 1, model 2), 64 experts a rank through
             the expert-parallel dispatch; (c) the same plan without the
             dispatch (the multipod regime's MoE layer): each rank routes
             every token and computes its 64 experts' block of the
             expert buffers (the ``act_shard_moe`` split), no expert
             leaf all-gathered over model (judged by the collectives'
             payload shapes).  Each rank draws its shards as
             one process draws the whole (``launch.steps.build_step`` with
             ``mesh=``); the launch counts zeroed just before the round and
             read just after: K1 2 × S times on every rank (once a local
             step per dtype group) and no other kernel; each rank's
             parameter bytes those of the plan; the new global parameters
             (each rank's blocks) and the metrics against the one-process
             round on the same card, weights and batches (run while the
             ranks start, then freed): (a)-(c) the weights at
             ``TRAIN_SHARDED_TOL`` and each leaf's update (θ_new - θ_0)
             against the one-process update: its norm ratio within
             ``TRAIN_SHARDED_UPDATE_RATIO``, its relative difference at
             most ``TRAIN_SHARDED_UPDATE_RTOL``, where no update and the
             mesh's update doubled must both fail that check; each rank's peak,
             round time, time in gloo collectives and set-up;
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
             qwen3-0.6b, mamba2-2.7b, granite-moe-3b-a800m,
             whisper-base and internvl2-26b (2 rounds each, at most
             ``LM_STEPS_CAP`` = 4 local steps a client; granite: 12
             layers of 4 experts top-2, 2,048 wide, 269,998,848 params,
             the einsum dispatch; whisper: 2 encoder layers over 16
             frames, cross-attention, 256 learned positions; internvl2: 16
             patches of width 32 in front of the 256 tokens) at depth 1,
             then depth 0, from the same seed, the launch counts zeroed
             just before each run and read just after: finite losses,
             bit-identical across depths, K1 exactly once per lane-loop
             step; ``exec_time`` per round and the run's peak memory; the
             granite loss holds its load-balance term, and the peak of one
             more granite round is broken down;
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
             share, top kernels, K1's share) and the peak of a fourth
             broken down; then K1 at that shape
             against its plain version (bitwise) and timed with
             ``torch.lerp`` beside the bound, and K2 on the fl100m
             payload's fold (bitwise, timed);
19b. train LM full-width mesh — qwen3-0.6b at its published widths and
             dtypes (8 bf16 leaves of 596,115,456 values, 5 f32 of 65,536)
             through ``build_engine(lm_cfg=get_arch(...))`` on the tree +
             int8 mesh (``FULL_MESH``: the fl100m batches, cohort 4 over 4
             one-lane workers, 2 shards), 2 rounds at depths 1 and 0, the
             launch counts zeroed just before each run and read just
             after: finite, bit-identical losses, both dtypes kept after
             every round, K1 once per dtype group per worker-program step,
             K2 once per shard a round, ``combine_bytes`` 2 ×
             596,181,052; ``exec_time`` per round and the allocator's
             peak, and that of one more round broken down; then K2 on
             that payload's f32 twin ``[596,180,992]``
             over 13 leaves against its plain version (bitwise), timed
             beside its bound;
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
             memory, a profiled round (MLM: and one more, its peak broken
             down), and K1 timed at the task's ``[4, N]`` lane buffer;
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
             at 1), 8 rounds: off, 512 rows, and a byte budget holding
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
31. dryrun — ``repro_torch.launch.dryrun``: every (arch × shape) cell of
             the assignment counted on meta tensors (FLOPs by dtype,
             bytes, peak live bytes against the card's budget, the
             roofline terms, K1-K5's work) by ``DRYRUN_WORKERS`` niced
             processes started after the build; 32 cells must be ``ok``
             or ``fail`` with the op named, the 8 ``long_500k`` skips
             carry the reference's reason.  Four cells run on the card
             (``DRYRUN_RUNS``): qwen3-0.6b train_4k (S=32, b=8, 2 of 28
             layers; bf16 and f32 leaves, K1 twice a step), qwen3-0.6b
             and mamba2-2.7b
             prefill_32k (one prompt through K4 and K5, all ``wgmma``),
             mamba2-2.7b long_500k; each must fit by the count, not run
             out of memory nor pass the counted peak by more than 5 %,
             give finite outputs, launch ``DRYRUN_LAUNCHES``, and its
             counted matrix-product FLOPs must be within 1 % of
             torch.profiler's; step time, ``mfu``, the roofline fraction
             and the predicted beside the measured peak; K1 at the train
             cell's lane buffers (bf16 within 1 ulp of its plain version,
             f32 bitwise), K4 at 32k positions against its plain version
             one kv head at a time and against SDPA, K5 at 32k against
             its plain version, K4 and K5 timed there beside SDPA and
             K5's plain version;
32. the ``kernels`` line (K1-K5; K1's and K2's launches on the LM training,
   task, FedMedian, resume and cache paths beside the main ones, K1 timed
   at the tasks' lane buffers, K4's launches on the MoE, VLM and hybrid
   serve paths and its timing at those shapes, K5's on the hybrid path and
   its timing at jamba's shape and a mesh rank's, K1's, K4's and K5's
   dry-run launches),
   then the card line and the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failed phase raises, so the script exits non-zero and prints no last
line.  It also fails where no CUDA card is present, and where the repo's
``src/`` is missing.  ``--profile-out DIR`` adds a torch.profiler pass over
two rounds of the main path (``DIR/fused``) and of the mesh path
(``DIR/mesh``): the trace, per-kernel device time and per-op host time.
``--dryrun-out DIR`` writes every dry-run record there as JSON (one file a
cell, ``__run`` for the cells run on the card), which
``python -m repro_torch.launch.report --dir DIR`` renders.
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
import tempfile  # noqa: E402
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
# jamba-v0.1-52b's serve shape: 128 heads of 64 (d_inner 8,192), one
# group, state 16: the smallest state K5's wgmma route takes.
SSD_HYBRID = (SERVE_BATCH, SERVE_PROMPT, 128, 64, 1, 16, 128)
# The same on one rank of phase 14b's (1, 2) mesh: its 64 heads.
SSD_HYBRID_RANK = (SERVE_BATCH, SERVE_PROMPT, 64, 64, 1, 16, 128)
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
# A bf16 reroute moves granite's token (top-8 of 40 experts 512 wide) by a
# few hundredths on the logits, and every compared token is held.  jamba
# routes a token to 2 of 16 experts 14,336 wide, so a reroute swaps half of
# its MoE output: its bf16 checks hold the compared tokens whose experts
# agree in both routes at every MoE layer (reporting the rerouted ones), as
# its f32 checks hold those clear of near-ties.  Its bf16 prefill + decode
# against forward (no kernel on either side: the decode steps take the
# recurrent SSM step and M = 4 GEMMs) is held wider, from what an H100
# measured: the f32 routes agree within 4.4e-5 on logits up to 4.8, so the
# decode path is right, while each bf16 prefill lies up to 1.59 from the f32
# one (bf16 roundings grown through 14,336-wide experts, and reroutes of
# earlier tokens reaching later ones through the SSM state and attention)
# and the two bf16 routes differ by up to 0.59.  The kernel routes (K4 + K5
# against dense attention + the chunked SSD) stay at MOE_BF16_TOL.
HYBRID_DECODE_BF16_TOL = dict(atol=1.0, rtol=0.05)
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
# tokens.  Cut to 12 of its 48 layers (19.9 B weights took 430-550 s to
# draw on the CPU when the phase was written; it keeps the cut, and every
# check as it was, now that the weights are drawn on the card).
VLM_ARCH = "internvl2-26b"
VLM_LAYERS = 12
VLM_PARAMS = 5_839_411_200    # the reference's count at 12 layers
# The hybrid: jamba-v0.1-52b (arXiv:2403.19887) at every published width and
# dtype (bf16 matrices; f32 norms and Mamba A, D and dt-bias rows) with
# attn_impl and ssd_impl "pallas" and its own moe_impl "scatter": the one
# shipped arch whose stack holds Mamba-2 (K5), attention (K4) and a routed
# MoE (16 experts top-2, 14,336 wide).  Cut to one 8-layer period of its 32
# (7 Mamba-2 layers, 1 attention layer, 4 MoE layers; 26.5 GB in bf16): the
# whole model is 103 GB.  The same traffic as the other serve phases.
HYBRID_ARCH = "jamba-v0.1-52b"
HYBRID_LAYERS = 8
HYBRID_PARAMS = 13_267_598_848   # the reference's count at 8 layers
# The f32 route checks hold the period's weights upcast (53.07 GB; the bf16
# copy is freed first).  A dropless f32 MoE over all 4 prompts would add
# ~23 GB of [16, 8256, 14336] expert buffers beside them, past the card's
# 80 GB, so the f32 checks serve the first HYBRID_F32_BATCH prompts (~12 GB).
HYBRID_F32_BATCH = 2
# The hybrid split over a (data 1, model 2) mesh of 2 gloo ranks sharing the
# card (NCCL refuses two ranks on one card): each rank holds half of every
# split leaf under the plan's fsdp_tp specs and 8 of the 16 experts.  Its
# attention (16 of the 32 query heads, 4 of the 8 kv heads: K4 at q [4,
# 2048, 16, 128]), dense MLPs, embedding and head compute the rank's part,
# the residual stream split over the sequence between blocks (the plan's
# sequence parallelism); each Mamba mixer its 64 of the 128 heads (K5 at
# x [4, 2048, 64, 64]: SSD_HYBRID_RANK) after one all-gather of the packed
# in-projection's columns, the MoE layers through the plan's
# make_ep_dispatch (seq_chunk 2048).  Each rank's logits are its half of
# the vocabulary, gathered whole for the checks.  The same prompts as
# phase_serve_hybrid; MESH_DECODE greedy steps into a cache of
# phase_serve_hybrid's length (SERVE_MAX_LEN), each rank holding half its
# slots and attending over them (the flash-decode combine); the phase's
# share of the script's time limit.
MESH_SHAPE, MESH_AXES = (1, 2), ("data", "model")
MESH_DECODE = 4
MESH_TIMEOUT_S = 300
# The expert-parallel dispatch alone, in f32 at one jamba MoE layer's widths
# ([16, 4096, 14336] experts), against moe_layer_3d("scatter") in one
# process: the k-sum is split over the ranks (rtol 1e-4).
MESH_EP_TOKENS = (2, 2048)
MESH_EP_TOL = dict(rtol=1e-4, atol=1e-5)
# The sharded training step (phase 14c): one federated round of the
# reference's train_4k plan on a mesh of gloo ranks sharing the card, at the
# published widths and dtypes, against the port's one-process round on the
# same card, the same weights (drawn from TRAIN_SHARDED_SEED) and batches.
# (a) qwen3-0.6b, tp on (data 2, model 2): two workers over data, each
#     worker's layers split over model (8 of the 16 heads, half of each
#     MLP and of the vocabulary a rank; each split product all-reduced).
# (b) qwen3-moe-235b-a22b, fsdp_tp on (data 1, model 2): the plan of the
#     94-layer arch, its config cut to 1 layer (7.47 GB); 32 of the 64
#     heads and 64 experts a rank (the expert-parallel dispatch), the
#     stream split over the sequence between blocks.  The dispatch routes
#     the whole sequence at once (the reference's plan: seq_chunk 0 below
#     4,096-wide experts) where a MoE layer without it routes blocks of
#     moe_seq_chunk (512), and with capacity 1.25 the two drop different
#     tokens: the one-process round routes the dispatch's groups.
# (c) the same plan without the dispatch, as the reference's multipod plan
#     trains this arch (workers over pod: no dispatch): the plan's
#     act_shard_moe split, each rank routing every token in moe_seq_chunk
#     (512) blocks, as the one-process round does, and computing its 64
#     experts' [64, C, D] buffers from its experts gathered over data only
#     (none here: data 1); the ranks' contributions reduce-scattered over
#     the sequence.
# A row-parallel product and the dispatch's k-sum are summed over the ranks
# in another order than one process sums them (rounded once from f32 where
# one process sums in bf16), so the bf16 weights may move by a few ulps:
# each is held by TRAIN_SHARDED_TOL and the update check
# (TRAIN_SHARDED_UPDATE_RATIO, _RTOL).
# Each cut S to 2 local steps, one client a lane, b to 2 sequences ((a) to
# 1: the script's time on a slow host).
TRAIN_SHARDED_RUNS = (
    {"arch": "qwen3-0.6b", "mesh": (2, 2), "S": 2, "b": 1, "n_layers": None,
     "dispatch": False},
    {"arch": "qwen3-moe-235b-a22b", "mesh": (1, 2), "S": 2, "b": 2,
     "n_layers": 1, "dispatch": True},
    {"arch": "qwen3-moe-235b-a22b", "mesh": (1, 2), "S": 2, "b": 2,
     "n_layers": 1, "dispatch": False})
TRAIN_SHARDED_SEED = 27
TRAIN_SHARDED_TOL = dict(atol=1e-3, rtol=1e-2)
TRAIN_SHARDED_LOSS_RTOL = 1e-3
# The round's update is far below the weights' scale (lr 0.05 on gradients
# of ~1e-4; most bf16 elements do not move), so the weights' tolerance
# alone passes a round that left θ as it was.  Each leaf whose one-process
# update Δ = θ_new - θ_0 is not zero is also held by the mesh update D:
# |D| / |Δ| within TRAIN_SHARDED_UPDATE_RATIO (no update gives 0, a doubled
# one 2) and |D - Δ| / |Δ| at most TRAIN_SHARDED_UPDATE_RTOL (no update
# gives 1).  The latter is loose because a bf16 element moves only where
# its update passes half an ulp: the last bits of the gradient decide which
# elements move (measured at (b): ratios 0.9995-1.0026, |D - Δ| / |Δ| up
# to 0.21, 0.045 on the f32 leaves).
TRAIN_SHARDED_UPDATE_RATIO = (0.95, 1.05)
TRAIN_SHARDED_UPDATE_RTOL = 0.4
TRAIN_SHARDED_TIMEOUT_S = 600
# Kernel-name fragments of cuBLAS' GEMMs in a profile.
GEMM_KERNELS = ("gemm", "gemv", "nvjet", "xmma", "cutlass")
# The peak breakdowns: trace entries kept while one call is recorded (a call
# that makes more fails), and how close the groups must sum to the
# allocator's peak of the same call.
HISTORY_ENTRIES = 2_000_000
BREAKDOWN_RTOL = 0.01
# Federated LM training (--arch, f32 as the reference trains): the
# reference's fl100m preset through the CLI (2 rounds each of qwen3,
# mamba2, granite-moe, whisper and internvl2, its default cohort 8 over 2
# workers x 2 lanes), the mesh path with
# int8 shard uploads (4 workers over 2 shards), and qwen3-0.6b at its
# published widths through the same builder at the fl100m preset's "lm"
# batches of 8 x 256 tokens, cohort 4 on 1 worker x 2 lanes, 4 local steps
# a client: 2 clients a lane fill the S = 8 bucket with no padded step.
# Through the CLI each client takes at most LM_STEPS_CAP local steps (the
# CLI's default is 8): the phases' depth is cut so that the script stays
# inside its time limit on a host ~1.3x slower than the usual one.
LM_TRAIN = (("qwen3-0.6b", 2), ("mamba2-2.7b", 2), (MOE_ARCH, 2),
            (AUDIO_ARCH, 2), (VLM_ARCH, 2))
LM_STEPS_CAP = 4
LM_MESH_ARGS = ["--workers", "4", "--mesh-workers", "2", "--combine-mode",
                "tree", "--combine-compress", "int8"]
LM_MESH_ROUNDS = 2
FULL = dict(preset="fl100m", cohort=4, workers=1, concurrency=2,
            steps_cap=4, seed=0)
FULL_ROUNDS = 2
# qwen3-0.6b at its published widths AND dtypes (bf16 matrices, f32 norm
# scales: 13 leaves) on the mesh path: the fl100m batches of 8 x 256
# tokens, cohort 4 over 4 workers of one lane each (up to 8 local steps a
# client, the S = 8 bucket), 2 shards, tree combine, int8 uploads; 2
# rounds at depths 1 and 0.
FULL_MESH = dict(preset="fl100m", cohort=4, workers=4, concurrency=1,
                 steps_cap=8, seed=0, mesh_workers=2, combine_mode="tree",
                 combine_compress="int8")
FULL_MESH_ROUNDS = 2
FULL_LEAVES = {"bfloat16": (8, 596_115_456), "float32": (5, 65_536)}
FULL_INT8_PAYLOAD = 596_181_052   # N int8 codes + 13 f32 scales + 8 B
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
# draw of 64 clients a round (hot clients recur), 8 rounds; the cache off,
# 512 rows, and a byte budget that holds every batch of the population.
# A batch row is x [20, 64] f32 + y [20] int32 (``_probe_row_bytes``).
# The Zipf head draws clients whose local SGD diverges at SR's learning
# rate, cache on or off, in the reference as in the port: on the
# reference's data and weights both give NaN in round 0 without a clip
# (``tests/_torch_sr_zipf_reference.py``).  So these runs clip each step's
# gradient at global norm 1 (``--grad-clip 1.0``), as the reference's
# heavier Zipf recipe (exponent 1.6) does; its cache recipe sets none.
CACHE_ROUNDS, CACHE_COHORT, CACHE_ROWS = 8, 64, 512
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
# The dry-run (M18): every (arch × shape) cell of the assignment counted on
# meta tensors by ``repro_torch.launch.dryrun.run_cell`` in DRYRUN_WORKERS
# background processes (niced; started after the build, they count while
# the earlier phases run), and four cells run on the card at their
# published widths and dtypes with the overrides each needs: qwen3's
# planned b=64 holds ~69 GB of dense f32 attention scores a layer, so its
# round runs 32 steps of 8 (the same 256 sequences of 4,096 tokens), cut to
# 2 of its 28 layers to fit the script's time (the whole depth took 148 s
# a round, 7 layers 44 s, 4 layers 29 s); the 32k prefills take one prompt
# through K4 and K5.
DRYRUN_WORKERS = 4
DRYRUN_RUNS = (("qwen3-0.6b", "train_4k", {"S": 32, "b": 8, "n_layers": 2}),
               ("qwen3-0.6b", "prefill_32k", {"b": 1, "attn_impl": "pallas"}),
               ("mamba2-2.7b", "prefill_32k", {"b": 1, "ssd_impl": "pallas"}),
               ("mamba2-2.7b", "long_500k", {}))
# Each cell's kernel launches in its timed call: K1 once per dtype group
# (bf16 and f32) a lane-loop step, K4 once a qwen3 layer, K5 once a mamba2
# layer, none in a decode step.
DRYRUN_LAUNCHES = {("qwen3-0.6b", "train_4k"): {"fedavg_accum": 2 * 32},
                   ("qwen3-0.6b", "prefill_32k"): {"flash_attention": 28},
                   ("mamba2-2.7b", "prefill_32k"): {"ssd": 64},
                   ("mamba2-2.7b", "long_500k"): {}}
# Counted aten matrix-product FLOPs against torch.profiler's for one call.
DRYRUN_FLOPS_RTOL = 0.01
# The allocator's peak may pass the counted one by this share at most: the
# count holds the step's storages and the in-op workspaces it knows of, the
# card adds the CUDA context's and cuBLAS' own (~0.1 GB).
DRYRUN_PEAK_RTOL = 0.05
K4_32K = (1, 32768, 16, 8, 128)            # qwen3's b, s, hq, hkv, d
SSD_32K = (1, 32768, 80, 64, 1, 128, 128)  # mamba2's b, s, h, p, g, n, chunk


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


T_START = time.perf_counter()


def clock(after: str) -> None:
    """The script's seconds so far, after the phases named ``after``."""
    emit({"phase": "clock", "after": after,
          "s": time.perf_counter() - T_START})


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


def peak_flops(dtype) -> float:
    """The card's peak rate for arithmetic in ``dtype`` (a kernel's
    ``Work.dtype``): dense bf16 on the tensor cores, else f32."""
    import torch
    return BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS


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
    from repro_torch.kernels import ref, work
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
    w = work.fedavg_accum(acc.shape, acc.dtype)
    nbytes = w.bytes
    bw = mem_bw(device_name)
    bytes_ms = nbytes / bw * 1e3
    ops_ms = w.flops / peak_flops(w.dtype) * 1e3
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
    from repro_torch.kernels import ref, work
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
    w = work.dequant_merge(n)
    nbytes = w.bytes
    bytes_ms = nbytes / mem_bw(device_name) * 1e3
    ops_ms = w.flops / peak_flops(w.dtype) * 1e3
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
    and bf16, the qwen3, granite-moe, internvl2 and jamba serve shapes in
    f32 and bf16, one
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
    hyb = _hybrid_cfg()
    serve_hyb = (SERVE_BATCH, SERVE_PROMPT, hyb.n_heads, hyb.n_kv_heads,
                 hyb.resolved_head_dim)
    cases += [(serve, SERVE_PROMPT, True, torch.float32, False),
              (serve, SERVE_PROMPT, True, bf16, False),
              (ragged, RAGGED_PROMPT, True, bf16, False),
              # granite-moe's serve shape: head dim 64, GQA group 3
              (serve_moe, SERVE_PROMPT, True, torch.float32, False),
              (serve_moe, SERVE_PROMPT, True, bf16, False),
              # internvl2's: 2,304 positions (9 kv blocks of 256), group 6
              (serve_vlm, serve_vlm[1], True, torch.float32, False),
              (serve_vlm, serve_vlm[1], True, bf16, False),
              # jamba's: 32 heads of 128, group 4
              (serve_hyb, SERVE_PROMPT, True, torch.float32, False),
              (serve_hyb, SERVE_PROMPT, True, bf16, False),
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
                                                   serve_moe, serve_vlm,
                                                   serve_hyb):
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
    from repro_torch.kernels import ref, work
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
        w = work.rmsnorm(rows, d, x.dtype)
        nbytes = w.bytes
        bytes_ms = nbytes / mem_bw(device_name) * 1e3
        ops_ms = w.flops / peak_flops(w.dtype) * 1e3
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
    from repro_torch.kernels import ref, work
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
    w = work.flash_attention(q.shape, k.shape, q.dtype, causal=True)
    flops, nbytes = w.flops, w.bytes
    ops_ms = flops / peak_flops(w.dtype) * 1e3
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
    sweep in f32 and bf16, the mamba2 and jamba serve shapes in f32 and
    bf16, a ragged 1,000-row prompt in bf16, and the wgmma route's cases in bf16
    (``SSD_TOL``).  Every case must take the route its dtype and widths
    name."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd as k5
    gen = torch.Generator().manual_seed(12)
    cases = [(shape, dt, False) for dt in (torch.float32, torch.bfloat16)
             for shape in SSD_SWEEP]
    cases += [(SSD_SERVE, torch.float32, True),
              (SSD_SERVE, torch.bfloat16, True),
              (SSD_RAGGED, torch.bfloat16, True),
              (SSD_HYBRID, torch.float32, True),
              (SSD_HYBRID, torch.bfloat16, True),
              (SSD_HYBRID_RANK, torch.float32, True),
              (SSD_HYBRID_RANK, torch.bfloat16, True)]
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


def phase_timing_k5(torch, device_name: str, shape=SSD_SERVE) -> dict:
    """K5 and its plain version at a serve shape (default mamba2's; bf16,
    the state returned, as prefill calls it).  No single PyTorch call
    computes the SSD, so there is no library time."""
    from repro_torch.kernels import ops, ref, work
    from repro_torch.kernels import ssd as k5
    gen = torch.Generator().manual_seed(13)
    args = _ssd_inputs(torch, shape, torch.bfloat16, gen, model_like=True)
    ck = shape[6]
    runs = {"kernel": lambda: k5.ssd_bshp(*args, chunk=ck, want_state=True),
            "plain": lambda: ref.ssd_chunks_ref(*args, chunk=ck)}
    best = _best_of(runs, (("kernel", "plain"), ("plain", "kernel"),
                           ("kernel", "plain")), iters=5, warmup=1)
    x, dt, B = args[0], args[1], args[3]
    w = work.ssd(x.shape, B.shape, x.dtype, dt.dtype,
                 chunk=ops.ssd_chunk(x.shape[1], ck), state=True)
    nbytes, flops = w.bytes, w.flops
    bytes_ms = nbytes / mem_bw(device_name) * 1e3
    ops_ms = flops / peak_flops(w.dtype) * 1e3
    out = {"ms": best["kernel"], "plain_ms": best["plain"],
           "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "shape": list(shape), "dtype": "bfloat16", "bytes": nbytes,
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
    from repro_torch.launch.steps import device_params
    dev = torch.device("cuda")
    cfg = _serve_cfg()
    params, init_s = _sync_s(torch, lambda: device_params(cfg, 0, dev))
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


def _hybrid_cfg(dtype: str = "bfloat16"):
    from dataclasses import replace
    from repro_torch.configs import get_arch
    return replace(get_arch(HYBRID_ARCH), n_layers=HYBRID_LAYERS,
                   attn_impl="pallas", ssd_impl="pallas", dtype=dtype)


def _hybrid_rank_cfg():
    """The heads one rank of the (1, 2) mesh attends with (phase 14b):
    half of jamba's query and kv heads, at its head width."""
    from dataclasses import replace
    cfg = _hybrid_cfg()
    m = MESH_SHAPE[1]
    return replace(cfg, n_heads=cfg.n_heads // m,
                   n_kv_heads=cfg.n_kv_heads // m,
                   head_dim=cfg.resolved_head_dim)


def _layer_counts(cfg) -> dict:
    """The layers of each kind in ``cfg``'s stack, from its layer plan:
    attention and Mamba-2 mixers, MoE MLPs."""
    from repro_torch.models import lm
    plan = lm.layer_plan(cfg)
    periods = cfg.n_layers // len(plan)
    return {"attn": periods * sum(k.mixer == "attn" for k in plan),
            "mamba": periods * sum(k.mixer == "mamba" for k in plan),
            "moe": periods * sum(k.mlp == "moe" for k in plan)}


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
    bf16, ``ssd_impl="pallas"``, weights drawn on the card: one
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
    from repro_torch.launch.steps import device_params
    dev = torch.device("cuda")
    cfg = _ssm_cfg()
    params, init_s = _sync_s(torch, lambda: device_params(cfg, 0, dev))
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
                   tol: dict, tie_gap: float,
                   hold_rerouted: bool = True) -> dict:
    """Logits ``a`` and ``b`` (``[batch, len(positions), vocab]``) of two
    routes, held at ``tol`` on the compared tokens whose routing gap is at
    least ``tie_gap`` at every MoE layer in both routes (0: all of them),
    and, unless ``hold_rerouted``, whose experts are the same in both
    routes at every MoE layer; with the count of (token, layer) routing
    decisions that differ."""
    ga = _route_grid(torch, calls_a, n_moe, a.shape[0])
    gb = _route_grid(torch, calls_b, n_moe, a.shape[0])
    differ = (ga["experts"] != gb["experts"]).any(-1)         # [L, b, S]
    near = (ga["gap"] < tie_gap) | (gb["gap"] < tie_gap)
    clear = ~near[:, :, positions].any(0)                      # [b, P]
    rerouted = differ[:, :, positions].any(0)
    skipped = torch.zeros_like(clear) if hold_rerouted else clear & rerouted
    held = clear & ~skipped
    res = _compare(torch, a[held], b[held], tol)
    res.update({"compared_tokens": int(held.sum()),
                "near_tie_tokens_skipped": int((~clear).sum()),
                "rerouted_tokens_skipped": int(skipped.sum()),
                "routing_decisions": differ.numel(),
                "routing_decisions_differ": int(differ.sum()),
                "compared_tokens_whose_routing_differs": int(
                    differ[:, :, positions].any(0).sum())})
    return res


def _moe_route_checks(torch, params, cfg, tokens, generated, tol,
                      tie_gap, hold_rerouted: bool = True,
                      decode_tol: dict | None = None) -> dict:
    """The MoE serve path's routes against each other (``_route_compare``):
    the pallas prefill (K4, and K5 where the stack has Mamba-2 layers)
    against the plain one (dense attention, the chunked SSD) at the served
    capacity factor; a dropless prefill + decode (teacher-forced with
    ``generated``) against a dropless ``forward``, as
    tests/test_archs.py:80 compares them (at ``decode_tol`` where given);
    a 1,000-token prompt through both routes, with its kernel launches.  Also the dropped-slot share of
    the pallas prefill, and the two prefills' logits (``pallas_logits``,
    ``dense_logits``)."""
    from dataclasses import replace
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    b, s = tokens.shape
    n_moe = _layer_counts(cfg)["moe"]
    dense = replace(cfg, attn_impl="dense", ssd_impl="chunked")
    dropless = replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)

    def prefill(c, toks):
        with _Routing(torch) as r:
            logits, _ = lm.prefill(params, {"tokens": toks}, c)
        return _vocab(logits, cfg)[:, None], r.calls

    lp, rp = prefill(cfg, tokens)
    ld, rd = prefill(dense, tokens)
    out = {"pallas_vs_dense_prefill": _route_compare(
               torch, rp, rd, n_moe, [s - 1], lp, ld, tol, tie_gap,
               hold_rerouted),
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
        full[:, s - 1:], decode_tol or tol, tie_gap, hold_rerouted)
    out["dropless_capacity"] = {"prefill": r.calls[0]["capacity"],
                                "decode": r.calls[-1]["capacity"],
                                "forward": rf.calls[0]["capacity"]}
    del full, served, r, rf
    ops.reset_launch_counts()
    lr, rr = prefill(cfg, tokens[:, :RAGGED_PROMPT])
    out["ragged_k4_launches"] = ops.launch_counts()["flash_attention"]
    out["ragged_k5_launches"] = ops.launch_counts()["ssd"]
    lrd, rrd = prefill(dense, tokens[:, :RAGGED_PROMPT])
    out["ragged_s"] = RAGGED_PROMPT
    out["ragged_pallas_vs_dense"] = _route_compare(
        torch, rr, rrd, n_moe, [RAGGED_PROMPT - 1], lr, lrd, tol, tie_gap,
        hold_rerouted)
    return out


def _check_moe_routes(label: str, res: dict, cfg) -> None:
    """Every route comparison of ``_moe_route_checks`` held, each on some
    tokens, and the ragged prompt's launches one K4 per attention layer
    and one K5 per Mamba-2 layer (``cfg`` routes both through their
    kernels)."""
    for key, val in res.items():
        if isinstance(val, dict) and "close" in val:
            check(val["close"], f"{label} {key}: {val}")
            check(val["compared_tokens"] > 0,
                  f"{label} {key}: no token compared")
    n = _layer_counts(cfg)
    check(res["ragged_k4_launches"] == n["attn"]
          and res["ragged_k5_launches"] == n["mamba"],
          f"{label} ragged prefill: K4 {res['ragged_k4_launches']}, K5 "
          f"{res['ragged_k5_launches']} for {n}")


def phase_serve_moe(torch) -> dict:
    """The MoE serve path: granite-moe-3b-a800m at its published widths and
    depth, bf16, ``attn_impl="pallas"``, ``moe_impl="scatter"``, weights
    drawn on the card: one prefill of 4 x 2,048 tokens (K4 exactly
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
    from repro_torch.launch.steps import device_params
    dev = torch.device("cuda")
    cfg = _moe_cfg()
    params, init_s = _sync_s(torch, lambda: device_params(cfg, 0, dev))
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
        _check_moe_routes(f"MoE serve {name}", res, cfg)
    return {"params": params, "tokens": tokens, "launches": after_prefill,
            "k4_routes_prefill": routes_prefill,
            "dropped_share": bf16["dropped_slots_prefill"]["share"],
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": sum(step_s) / len(step_s) * 1e3}


def phase_serve_hybrid(torch) -> dict:
    """The hybrid serve path: jamba-v0.1-52b at its published widths and
    dtypes cut to one 8-layer period, ``attn_impl`` and ``ssd_impl``
    ``"pallas"``, ``moe_impl="scatter"``, weights drawn on the card: one
    prefill of 4 x 2,048 tokens (K4 once per attention layer and K5 once
    per Mamba-2 layer, all on their wgmma routes) and 16 greedy decode
    steps (neither kernel), the launch counts zeroed just before and read
    just after; finite logits; the prefill's dropped-slot share at capacity
    factor 1.25; then the route checks (``_moe_route_checks``) in bf16
    (``MOE_BF16_TOL``; prefill + decode against ``forward`` at
    ``HYBRID_DECODE_BF16_TOL``), on the tokens whose experts agree in both
    routes; the peak of one more prefill broken down.  The f32 checks follow in :func:`phase_serve_hybrid_f32`, on
    these weights upcast."""
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd as k5
    from repro_torch.models import lm
    from repro_torch.launch.steps import device_params
    dev = torch.device("cuda")
    cfg = _hybrid_cfg()
    n = _layer_counts(cfg)
    params, init_s = _sync_s(torch, lambda: device_params(cfg, 0, dev))
    n_params = lm.param_count(params)
    check(n_params == HYBRID_PARAMS, f"{HYBRID_ARCH}: {n_params} params")
    gen = torch.Generator().manual_seed(25)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen).to(dev)
    lm.prefill(params, {"tokens": tokens[:, :128]}, cfg, max_len=144)  # warm
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    (logits, cache), prefill_s = _sync_s(
        torch, lambda: lm.prefill(params, {"tokens": tokens}, cfg,
                                  max_len=SERVE_MAX_LEN))
    after_prefill = ops.launch_counts()
    k4_prefill, k5_prefill = dict(fl.ROUTE_LAUNCHES), dict(k5.ROUTE_LAUNCHES)
    prefill_peak = torch.cuda.max_memory_allocated()
    generated, step_logits, step_s = _greedy_decode(
        torch, params, cache, logits, SERVE_PROMPT, cfg)
    launches = ops.launch_counts()
    k4_decode = {k: v - k4_prefill[k] for k, v in fl.ROUTE_LAUNCHES.items()}
    k5_decode = {k: v - k5_prefill[k] for k, v in k5.ROUTE_LAUNCHES.items()}
    del cache
    check(after_prefill["flash_attention"] == n["attn"]
          and after_prefill["ssd"] == n["mamba"],
          f"{HYBRID_ARCH} prefill launched {after_prefill} for {n}")
    check(k4_prefill == {"simt": 0, "wgmma": n["attn"]}
          and k5_prefill == {"simt": 0, "wgmma": n["mamba"]},
          f"prefill launches by route: K4 {k4_prefill}, K5 {k5_prefill}")
    check(launches["flash_attention"] == n["attn"]
          and launches["ssd"] == n["mamba"],
          f"{HYBRID_ARCH}: a kernel launched in decode: {launches}")
    check(k4_decode == k5_decode == {"simt": 0, "wgmma": 0},
          f"decode launches by route: K4 {k4_decode}, K5 {k5_decode}")
    _check_logits(torch, step_logits, cfg)
    emit({"phase": "serve_hybrid", "arch": HYBRID_ARCH,
          "attn_impl": cfg.attn_impl, "ssd_impl": cfg.ssd_impl,
          "moe_impl": cfg.moe_impl, "dtype": cfg.dtype,
          "n_layers": cfg.n_layers, "layers": n, "n_params": n_params,
          "n_experts": cfg.n_experts, "top_k": cfg.top_k,
          "capacity_factor": cfg.capacity_factor, "batch": SERVE_BATCH,
          "prompt": SERVE_PROMPT, "decode_steps": SERVE_DECODE,
          "reduced": {"n_layers": f"{HYBRID_LAYERS} of 32: one period of "
                      f"every layer kind (the whole model is 103 GB in "
                      f"bf16, the period 26.5 GB)",
                      "f32_batch": f"the f32 route checks serve "
                      f"{HYBRID_F32_BATCH} of the {SERVE_BATCH} prompts "
                      f"(53.07 GB of f32 weights leave no room for the "
                      f"dropless buckets of all 4)"},
          "init_params_s": init_s, "prefill_ms": prefill_s * 1e3,
          "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / prefill_s,
          "decode_ms_per_step": sum(step_s) / len(step_s) * 1e3,
          "decode_ms_steps": [x * 1e3 for x in step_s],
          "decode_tokens_per_s": SERVE_BATCH * len(step_s) / sum(step_s),
          "prefill_peak_bytes": prefill_peak,
          "launches_prefill": after_prefill,
          "launches_decode": {k: launches[k] - after_prefill[k]
                              for k in launches},
          "k4_routes_prefill": k4_prefill, "k5_routes_prefill": k5_prefill,
          "k4_routes_decode": k4_decode, "k5_routes_decode": k5_decode})
    bf16 = _moe_route_checks(torch, params, cfg, tokens, generated,
                             MOE_BF16_TOL, 0.0, hold_rerouted=False,
                             decode_tol=HYBRID_DECODE_BF16_TOL)
    check(torch.equal(bf16["pallas_logits"], _vocab(logits, cfg)),
          "a second pallas prefill differs from the first")
    _check_moe_routes("hybrid serve bf16", bf16, cfg)
    _peak_breakdown(torch, lambda: lm.prefill(params, {"tokens": tokens}, cfg,
                                              max_len=SERVE_MAX_LEN),
                    f"serve_hybrid: {HYBRID_ARCH} prefill")
    # The run the mesh phase is held to, with its routes: the same prefill
    # and the first MESH_DECODE steps, fed the tokens generated above.
    with _Kept(torch) as kept:
        lg, cache = lm.prefill(params, {"tokens": tokens}, cfg,
                               max_len=SERVE_MAX_LEN)
        steps = [lg]
        for i, nxt in enumerate(generated[:MESH_DECODE]):
            lg, cache = lm.decode_step(params, cache, nxt, SERVE_PROMPT + i,
                                       cfg)
            steps.append(lg)
    del cache
    mesh_ref = {"logits": torch.stack([_vocab(x, cfg) for x in steps],
                                      dim=1).cpu(),
                "generated": torch.cat(generated[:MESH_DECODE], 1).cpu(),
                "calls": kept.host_calls()}
    check(torch.equal(mesh_ref["logits"][:, 0], _vocab(logits, cfg).cpu()),
          "the routed prefill differs from the timed one")
    return {"params": params, "tokens": tokens, "generated": generated,
            "mesh_ref": mesh_ref,
            "bf16": bf16, "launches": after_prefill,
            "k4_routes_prefill": k4_prefill, "k5_routes_prefill": k5_prefill,
            "dropped_share": bf16["dropped_slots_prefill"]["share"],
            "prefill_ms": prefill_s * 1e3, "prefill_peak_bytes": prefill_peak,
            "decode_ms_per_step": sum(step_s) / len(step_s) * 1e3}


def phase_serve_hybrid_f32(torch, hybrid: dict) -> dict:
    """The hybrid route checks again with ``hybrid``'s weights upcast to
    f32 in place (the bf16 copy freed leaf by leaf), on its first
    ``HYBRID_F32_BATCH`` prompts, within ``MOE_F32_TOL`` on the tokens
    clear of routing near-ties; each bf16 prefill's distance from the f32
    one over those prompts.  The weights are freed at the end."""
    params, bf16 = hybrid.pop("params"), hybrid.pop("bf16")
    for key, val in list(params.items()):
        if key == "stack":
            for block in val.values():
                for name in list(block):
                    block[name] = block[name].float()
        else:
            params[key] = val.float()
    cfg = _hybrid_cfg("float32")
    b = HYBRID_F32_BATCH
    f32 = _moe_route_checks(torch, params, cfg, hybrid["tokens"][:b],
                            [g[:b] for g in hybrid["generated"]],
                            MOE_F32_TOL, MOE_F32_TIE_GAP)
    del params
    torch.cuda.empty_cache()
    bf16_vs_f32 = {route: _compare(torch, bf16.pop(f"{route}_logits")[:b],
                                   f32.pop(f"{route}_logits"), MOE_BF16_TOL)
                   for route in ("pallas", "dense")}
    emit({"phase": "serve_hybrid_checks", "tolerance": {
              "bfloat16": MOE_BF16_TOL,
              "bfloat16_prefill_decode_vs_forward": HYBRID_DECODE_BF16_TOL,
              "float32": MOE_F32_TOL},
          "tie_gap": {"bfloat16": 0.0, "float32": MOE_F32_TIE_GAP},
          "batch": {"bfloat16": SERVE_BATCH, "float32": b},
          "bfloat16": bf16, "float32": f32,
          "bf16_vs_f32_prefill": bf16_vs_f32})
    _check_moe_routes("hybrid serve f32", f32, cfg)
    return {"bfloat16": bf16, "float32": f32}


class _Kept:
    """While active, records every routing decision made through
    ``repro_torch.models.layers._route`` (the one-process dispatch and the
    expert-parallel one both route there): per call, each token's k
    experts in the router's order beside whether each slot was kept (its
    position under its expert's capacity), as ``experts [T, 2k]``.  It
    reads what the router computed and changes nothing."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        from repro_torch.models import layers
        self._layers, inner = layers, layers._route
        self._inner = inner

        def record(x, router_w, *, top_k, capacity_factor):
            out = inner(x, router_w, top_k=top_k,
                        capacity_factor=capacity_factor)
            _, _, idx, C, pos = out
            slot_pos = pos.gather(1, idx.reshape(-1, 1))[:, 0]
            kept = (slot_pos < C).reshape(idx.shape).long()
            self.calls.append(self.torch.cat([idx, kept], dim=1))
            return out

        layers._route = record
        return self

    def __exit__(self, *exc):
        self._layers._route = self._inner

    def host_calls(self) -> list:
        """The calls as ``_route_grid`` reads them, on the host (no
        near-tie gap: every token counts)."""
        torch = self.torch
        return [{"experts": c.cpu(), "gap": torch.ones(c.shape[0])}
                for c in self.calls]


def _timed_collectives(torch, seconds: list):
    """Wrap the gloo collectives of ``distributed.collectives`` so that each
    call's wall seconds (host staging included) add to ``seconds[-1]``;
    returns the undo."""
    from repro_torch.distributed import collectives as coll
    inner = {name: getattr(coll, name) for name in ("_all_reduce",
                                                    "_reduce_scatter",
                                                    "_gather")}

    def wrap(fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            seconds[-1] += time.perf_counter() - t0
            return out
        return timed

    for name, fn in inner.items():
        setattr(coll, name, wrap(fn))
    return lambda: [setattr(coll, n, f) for n, f in inner.items()]


def _wire_by_kind(seen: list) -> dict:
    """The wire bytes of the collectives ``seen`` (recorded through
    ``collectives.counting``) by kind: what a rank sends and, on a ring,
    receives."""
    out: dict = {}
    for c in seen:
        out[c.kind] = out.get(c.kind, 0.0) + c.wire_bytes
    return out


def _wire_by_kind_axis(seen: list) -> dict:
    """:func:`_wire_by_kind` by ``kind/axis``."""
    out: dict = {}
    for c in seen:
        key = f"{c.kind}/{c.axis}"
        out[key] = out.get(key, 0.0) + c.wire_bytes
    return out


def _expert_gathers(seen: list, cfg, mesh) -> list:
    """The all-gathers over ``model`` among ``seen`` whose payload has the
    shape of a MoE layer's expert leaf, whole or in part (``[e, d, F]`` or
    ``[e, F, d]`` with every expert or the rank's, ``D`` whole or over
    ``data``): ``(shape, bytes)`` of each."""
    if not cfg.moe:
        return []
    E, D, Fm = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    es = {E, E // mesh.axis_size("model")}
    ds = {D, D // mesh.axis_size("data")}
    shapes = {s for e in es for d in ds for s in ((e, d, Fm), (e, Fm, d))}
    return [(list(c.shape), c.bytes) for c in seen
            if (c.kind, c.axis) == ("all-gather", "model")
            and tuple(c.shape) in shapes]


def _ep_weights(torch, dev, gen):
    """One jamba MoE layer in f32 (router ``[4096, 16]``, experts ``[16,
    4096, 14336]``) and its tokens, drawn on the card from ``gen`` leaf by
    leaf: ``(name, tensor)`` in draw order."""
    D, E, Fm = 4096, 16, 14336
    shapes = (("x", MESH_EP_TOKENS + (D,), 1.0),
              ("router", (D, E), D ** -0.5),
              ("gate", (E, D, Fm), D ** -0.5), ("up", (E, D, Fm), D ** -0.5),
              ("down", (E, Fm, D), Fm ** -0.5))
    for name, shape, scale in shapes:
        yield name, torch.randn(shape, generator=gen, device=dev).mul_(scale)


EP_SPECS = {"x": (), "router": (), "gate": ("model", "data", None),
            "up": ("model", "data", None), "down": ("model", None, "data")}


def _mesh_rank(mesh, tokens, n_decode: int) -> dict:
    """One rank of ``phase_serve_hybrid_mesh``: the f32 dispatch check,
    then the jamba period served from this rank's shards."""
    import torch
    from dataclasses import replace
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.ep_dispatch import make_ep_dispatch
    from repro_torch.distributed.sharding import shard_leaf, tree_paths
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd as k5
    from repro_torch.launch import plan as tplan
    from repro_torch.launch.steps import device_params
    from repro_torch.models import lm
    dev = mesh.device
    out = {"coords": mesh.coords}
    # -- the dispatch alone, f32, one MoE layer's widths --------------------
    gen = torch.Generator(device=dev).manual_seed(26)
    w = {name: shard_leaf(t, EP_SPECS[name], mesh)
         for name, t in _ep_weights(torch, dev, gen)}
    disp = make_ep_dispatch(mesh, batch_axes=("data",), fsdp_axis="data",
                            seq_chunk=2048)
    ep_out, ep_aux = disp(w["x"], w["router"], w["gate"], w["up"], w["down"],
                          top_k=2, capacity_factor=1.25)
    out["ep"] = {"out": ep_out, "aux": ep_aux}
    del w, ep_out
    torch.cuda.empty_cache()
    # -- the plan of the cut config on this mesh ---------------------------
    base = _hybrid_cfg()
    plan = tplan.make_plan(base, "prefill_32k", mesh)
    cfg = replace(base, moe_dispatch=plan.cfg.moe_dispatch)
    shard = tplan.sharding_specs(plan, mesh)
    b, s = tokens.shape
    max_len = SERVE_MAX_LEN
    specs = {"params": shard["params"],
             "cache": tplan.cache_specs(cfg, shard["rules"], b, max_len,
                                        mesh),
             "act": shard["act"], "logits": shard["logits"]}
    pspec = dict(tree_paths(shard["params"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = device_params(cfg, 0, dev, keep=lambda path, x: shard_leaf(
        x, pspec[path], mesh))
    torch.cuda.synchronize()
    out.update(init_s=time.perf_counter() - t0, policy=plan.policy,
               batch_axes=list(plan.batch_axes),
               seq_chunk=2048 if cfg.moe_d_ff >= 4096 else 0,
               local_experts=params["stack"]["p1"]["moe_gate"].shape[1],
               param_bytes=sum(x.numel() * x.element_size()
                               for _, x in tree_paths(params)),
               param_bytes_specs=tplan.param_bytes_per_card(plan, mesh))
    kw = dict(mesh=mesh, specs=specs)
    toks = tokens.to(dev)
    lm.prefill(params, {"tokens": toks[:, :128]}, cfg, max_len=144, **kw)
    gloo = [0.0]
    undo = _timed_collectives(torch, gloo)
    # The shapes K5 is called at (read, nothing changed).
    ssd_shapes, real_ssd = [], ops.ssd

    def ssd_spy(*a, **k):
        ssd_shapes.append(tuple(a[0].shape))
        return real_ssd(*a, **k)

    ops.ssd = ssd_spy
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    wire_prefill, wire_steps = [], []
    with _Kept(torch) as kept:
        with coll.counting(wire_prefill.append):
            (logits, cache), prefill_s = _sync_s(torch, lambda: lm.prefill(
                params, {"tokens": toks}, cfg, max_len=max_len, **kw))
        launches = ops.launch_counts()
        routes = {"k4": dict(fl.ROUTE_LAUNCHES), "k5": dict(k5.ROUTE_LAUNCHES)}
        prefill_peak = torch.cuda.max_memory_allocated()
        gloo_prefill = gloo[-1]
        # Each rank's slice of the vocabulary, the whole gathered after
        # the timed call.
        steps, generated, step_s, gloo_steps = [
            lm.gather_logits(logits, cfg, **kw)], [], [], []
        for i in range(n_decode):
            nxt = steps[-1][:, :cfg.vocab_size].argmax(-1, keepdim=True)
            generated.append(nxt)
            gloo.append(0.0)
            wire_steps.append([])
            with coll.counting(wire_steps[-1].append):
                (lg, cache), dt = _sync_s(torch, lambda: lm.decode_step(
                    params, cache, nxt, s + i, cfg, **kw))
            steps.append(lm.gather_logits(lg, cfg, **kw))
            step_s.append(dt)
            gloo_steps.append(gloo[-1])
    undo()
    ops.ssd = real_ssd
    after = ops.launch_counts()
    out.update(
        logits=torch.stack([_vocab(x, cfg) for x in steps], dim=1),
        generated=torch.cat(generated, dim=1), calls=kept.host_calls(),
        launches_prefill=launches,
        launches_decode={k: after[k] - launches[k] for k in after},
        routes_prefill=routes,
        routes_decode={"k4": {k: v - routes["k4"][k]
                              for k, v in fl.ROUTE_LAUNCHES.items()},
                       "k5": {k: v - routes["k5"][k]
                              for k, v in k5.ROUTE_LAUNCHES.items()}},
        prefill_ms=prefill_s * 1e3, decode_ms_steps=[x * 1e3 for x in step_s],
        wire_bytes_prefill=_wire_by_kind(wire_prefill),
        wire_bytes_steps=[_wire_by_kind(w) for w in wire_steps],
        collectives_steps=[len(w) for w in wire_steps],
        gather_model_max_steps=[max([c.bytes for c in w if (
            c.kind, c.axis) == ("all-gather", "model")], default=0)
            for w in wire_steps],
        ssd_shapes=sorted(set(ssd_shapes)),
        local_vocab=logits.shape[-1],
        gloo_ms_prefill=gloo_prefill * 1e3,
        gloo_ms_steps=[x * 1e3 for x in gloo_steps],
        prefill_peak_bytes=prefill_peak,
        peak_bytes=torch.cuda.max_memory_allocated(),
        finite=all(bool(torch.isfinite(_vocab(x, cfg)).all())
                   for x in steps))
    return out


def _nccl_one_rank(torch, w: dict, want) -> bool:
    """The dispatch on a (1, 1) NCCL mesh (this process, world size 1) on
    ``w`` against ``want`` (``moe_layer_3d("scatter")``), bitwise; and the
    split layers' NCCL collectives (``reduce_scatter`` through
    ``reduce_scatter_tensor``, ``pmax``), which over one rank return their
    operand."""
    import datetime

    import torch.distributed as dist
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.ep_dispatch import make_ep_dispatch
    from repro_torch.launch.mesh import free_port, make_mesh
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120),
        device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh((1, 1), MESH_AXES, backend="nccl",
                         device=torch.device("cuda", 0))
        disp = make_ep_dispatch(mesh, batch_axes=("data",), fsdp_axis="data",
                                seq_chunk=2048)
        got = disp(w["x"], w["router"], w["gate"], w["up"], w["down"],
                   top_k=2, capacity_factor=1.25)
        x = w["x"][:, :64].to(torch.bfloat16)
        return (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and torch.equal(coll.reduce_scatter(x, mesh, "model", 1), x)
                and torch.equal(coll.pmax(x, mesh, "model"), x))
    finally:
        dist.destroy_process_group()


def phase_serve_hybrid_mesh(torch, ref: dict) -> dict:
    """The hybrid served from two ranks (see phase 14b): ``ref`` is phase
    14's routed run (``mesh_ref``).  The dispatch's one-process reference
    and the NCCL check run here first, then the ranks."""
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.models import layers
    dev = torch.device("cuda")
    cfg = _hybrid_cfg()
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(26)
    w = dict(_ep_weights(torch, dev, gen))
    with torch.no_grad():
        want = layers.moe_layer_3d(w["x"], w["router"], w["gate"], w["up"],
                                   w["down"], top_k=2, capacity_factor=1.25,
                                   impl="scatter", seq_chunk=2048)
    nccl_bitwise = _nccl_one_rank(torch, w, want)
    ep_want = (want[0].cpu(), float(want[1]))
    del w, want
    torch.cuda.empty_cache()
    tokens = ref["tokens"]
    res = run_on_mesh(_mesh_rank, MESH_SHAPE, MESH_AXES, backend="gloo",
                      device="cuda:0", args=(tokens, MESH_DECODE),
                      timeout_s=MESH_TIMEOUT_S)
    n = _layer_counts(cfg)
    r0 = res[0]
    m = MESH_SHAPE[1]
    # One token's packed in-projection or its query heads, bf16: no weight
    # and no cache leaf is all-gathered over model in a decode step.
    in_width = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state \
        + cfg.ssm_heads
    gather_bound = SERVE_BATCH * max(
        in_width, cfg.n_heads * cfg.resolved_head_dim) * 2
    rank_x = (SERVE_BATCH, SERVE_PROMPT, cfg.ssm_heads // m, cfg.ssm_head_dim)
    for r in res:
        check(r["ssd_shapes"] == [rank_x],
              f"rank {r['coords']}: K5 ran at {r['ssd_shapes']}, not at the "
              f"rank's heads {rank_x}")
        check(0 < max(r["gather_model_max_steps"]) <= gather_bound,
              f"rank {r['coords']}: a decode step all-gathered "
              f"{r['gather_model_max_steps']} bytes over model, past one "
              f"token's projections ({gather_bound})")
        check(r["param_bytes"] == r["param_bytes_specs"],
              f"rank {r['coords']}: {r['param_bytes']} parameter bytes, "
              f"the specs give {r['param_bytes_specs']}")
        check(r["local_experts"] == cfg.n_experts // MESH_SHAPE[1],
              f"rank {r['coords']} holds {r['local_experts']} experts")
        check(r["launches_prefill"]["flash_attention"] == n["attn"]
              and r["launches_prefill"]["ssd"] == n["mamba"],
              f"rank {r['coords']} prefill launched {r['launches_prefill']}")
        check(r["routes_prefill"] == {
            "k4": {"simt": 0, "wgmma": n["attn"]},
            "k5": {"simt": 0, "wgmma": n["mamba"]}},
            f"rank {r['coords']} prefill routes {r['routes_prefill']}")
        check(r["launches_decode"]["flash_attention"] == 0
              and r["launches_decode"]["ssd"] == 0,
              f"rank {r['coords']}: a kernel launched in decode")
        check(r["finite"], f"rank {r['coords']}: non-finite logits")
        check(r["local_vocab"] == cfg.padded_vocab // MESH_SHAPE[1],
              f"rank {r['coords']}'s logits are {r['local_vocab']} columns, "
              f"not its slice of the vocabulary")
        check(torch.equal(r["logits"], r0["logits"]),
              f"rank {r['coords']}'s logits differ from rank 0's")
        ep_close = torch.allclose(r["ep"]["out"], ep_want[0], **MESH_EP_TOL)
        check(ep_close, f"rank {r['coords']}: the f32 dispatch is "
              f"{_max_err(torch, r['ep']['out'], ep_want[0])} from "
              f"scatter")
    check(nccl_bitwise, "the (1, 1) NCCL dispatch differs from scatter, or "
          "its reduce-scatter or maximum from their operand")
    cmp = _mesh_compare(torch, ref, r0, cfg, n["moe"])
    check(cmp["prefill"]["close"] and cmp["prefill_decode"]["close"],
          f"mesh vs one process: {cmp}")
    check(cmp["prefill"]["compared_tokens"] > 0
          and cmp["prefill_decode"]["compared_tokens"] > 0,
          f"mesh vs one process: nothing compared: {cmp}")
    phase_s = time.perf_counter() - t_phase
    rec = {"phase": "serve_hybrid_mesh", "arch": HYBRID_ARCH,
           "mesh": dict(zip(MESH_AXES, MESH_SHAPE)), "backend": "gloo",
           "ranks_share": "cuda:0", "policy": r0["policy"],
           "batch_axes": r0["batch_axes"], "seq_chunk": r0["seq_chunk"],
           "local_experts": r0["local_experts"], "batch": SERVE_BATCH,
           "prompt": SERVE_PROMPT, "decode_steps": MESH_DECODE,
           "tolerance": {"prefill": MOE_BF16_TOL,
                         "prefill_decode": HYBRID_DECODE_BF16_TOL,
                         "ep_f32": MESH_EP_TOL},
           "vs_one_process": cmp,
           "ep_f32": {"tokens": list(MESH_EP_TOKENS),
                      "max_abs_diff": [_max_err(torch, r["ep"]["out"],
                                                ep_want[0]) for r in res],
                      "aux": [float(r["ep"]["aux"]) for r in res],
                      "aux_one_process": ep_want[1]},
           "nccl_1x1_bitwise": nccl_bitwise, "phase_s": phase_s,
           "decode_gather_bound_bytes": gather_bound,
           "ranks": [{k: r[k] for k in (
               "coords", "param_bytes", "init_s", "prefill_ms",
               "decode_ms_steps", "gloo_ms_prefill", "gloo_ms_steps",
               "wire_bytes_prefill", "wire_bytes_steps",
               "collectives_steps", "gather_model_max_steps", "ssd_shapes",
               "prefill_peak_bytes", "peak_bytes", "launches_prefill",
               "launches_decode", "routes_prefill", "routes_decode")}
               for r in res]}
    emit(rec)
    return {"launches": [r["launches_prefill"] for r in res],
            "routes": [r["routes_prefill"] for r in res],
            "launches_decode": [r["launches_decode"] for r in res],
            "phase_s": phase_s}


def _sharded_train_plan(run: dict, axes):
    """The reference's train_4k plan of ``run["arch"]`` on ``axes`` (a
    Mesh, whose hooks it makes, or axis sizes: no hooks, the one-process
    round), its config cut to ``run["n_layers"]`` and its round to
    ``run["S"]`` steps of ``run["b"]`` sequences (``TRAIN_SHARDED_RUNS``).
    Where the mesh's MoE layers go through the dispatch, the one-process
    round's route the dispatch's groups of tokens (``ep_seq_chunk``);
    without ``run["dispatch"]`` the plan's dispatch is dropped."""
    from dataclasses import replace
    from repro_torch.launch import plan as tplan
    plan = tplan.make_plan(run["arch"], "train_4k", axes)
    cfg = plan.cfg if run["n_layers"] is None else replace(
        plan.cfg, n_layers=run["n_layers"])
    if not run["dispatch"]:
        cfg = replace(cfg, moe_dispatch=None)
    elif cfg.moe_dispatch is None:
        cfg = replace(cfg, moe_seq_chunk=tplan.ep_seq_chunk(cfg))
    return replace(plan, S=run["S"], b=run["b"], cfg=cfg)


def _flat_args(args) -> tuple:
    """A train step's arguments with its parameters laid out flat (a
    ``FlatTree``): the round then works on them without another copy."""
    from repro_torch.kernels.layout import FlatLayout
    params, *rest = args
    layout = FlatLayout.of(params)
    return (layout.views(layout.flatten_groups(params)), *rest)


def _train_sharded_ranks(mesh, runs: tuple, ref_paths: list) -> list:
    """One rank of ``phase_train_sharded``: each run on its mesh (the first
    ranks of ``mesh``, ``launch.mesh.sub_mesh``; one spawn for all runs),
    None where the rank takes no part."""
    import torch
    from repro_torch.launch.mesh import sub_mesh
    out = []
    for run, ref_path in zip(runs, ref_paths):
        sub = sub_mesh(mesh, run["mesh"])
        out.append(None if sub is None else
                   _train_sharded_rank(sub, run, ref_path))
        torch.cuda.empty_cache()
    return out


def _train_sharded_rank(mesh, run: dict, ref_path: str) -> dict:
    """One run on one rank: the step of the cut plan on this rank's shards
    (drawn as one process draws the whole), one round with the launch
    counts zeroed just before and read just after, then its new shards
    and their update against the same blocks of the one-process round's
    new parameters (saved at ``ref_path``)."""
    import torch
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import tree_paths
    from repro_torch.kernels import ops
    from repro_torch.launch import plan as tplan
    from repro_torch.launch.steps import build_step
    entered = time.time()
    plan = _sharded_train_plan(run, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn, args = build_step(plan, mesh.device, seed=TRAIN_SHARDED_SEED,
                          mesh=mesh)
    args = _flat_args(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gloo = [0.0]
    undo = _timed_collectives(torch, gloo)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    seen = []
    with coll.counting(seen.append):
        (new, metrics), round_s = _sync_s(torch, lambda: fn(*args))
    launches = ops.launch_counts()
    undo()
    theta0 = args[0]
    out = {"coords": mesh.coords, "policy": plan.policy, "W": plan.W,
           "P": plan.P, "worker_axes": list(plan.worker_axes),
           "batch_axes": list(plan.batch_axes),
           "dispatch": plan.cfg.moe_dispatch is not None,
           "expert_split": plan.cfg.act_shard_moe is not None,
           "groups": len(theta0.flats),
           "param_bytes": sum(f.numel() * f.element_size()
                              for f in theta0.flats.values()),
           "param_bytes_specs": tplan.param_bytes_per_card(plan, mesh),
           "init_s": init_s, "round_ms": round_s * 1e3,
           "gloo_ms": gloo[-1] * 1e3, "gloo_share": gloo[-1] / round_s,
           "wire_bytes": _wire_by_kind(seen),
           "wire_bytes_axis": _wire_by_kind_axis(seen),
           "expert_gathers_model": _expert_gathers(seen, plan.cfg, mesh),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches,
           "metrics": {k: getattr(metrics, k) for k in metrics._fields}}
    del fn, args
    specs = dict(tree_paths(tplan.sharding_specs(plan, mesh)["params"]))
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    out["vs_one_process"] = _shard_compare(
        torch, new, theta0, ref, specs, dict(zip(MESH_AXES, mesh.coords)),
        dict(zip(MESH_AXES, mesh.shape)))
    out.update(entered=entered, left=time.time())
    return out


def _block_of(x, spec, coords: dict, sizes: dict):
    """The block of the whole leaf ``x`` that the rank at ``coords`` holds
    under ``spec``."""
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * sizes[a] + coords[a], n * sizes[a]
        if n > 1:
            blk = x.shape[i] // n
            x = x.narrow(i, idx * blk, blk)
    return x


def _shard_compare(torch, new, theta0, ref: dict, specs: dict, coords: dict,
                   sizes: dict) -> dict:
    """A rank's new shards ``new`` against the same blocks of the one-process
    round's new parameters ``ref`` (whole leaves on the host), both from
    this rank's old shards ``theta0``: the leaves and elements that differ,
    the largest difference, whether every block is within
    ``TRAIN_SHARDED_TOL``; and per leaf the sums that compare updates
    (``_update_compare``): of the one-process update ``Δ = ref - theta0``
    the sum of squares and the elements it moves, and for each candidate
    update ``D`` (the mesh's ``new - theta0``; the controls: none, and the
    mesh's doubled, rounded to the leaf's dtype) ``|D|²`` and
    ``|D - Δ|²``.  A block that several ranks hold counts once over them."""
    leaves = elements = 0
    worst, close = 0.0, True
    sums = {}
    for path, got in new.items():
        want = _block_of(ref[path], specs[path], coords, sizes).to(
            got.device)
        t0 = theta0[path].float()
        g, w = got.float(), want.float()
        # The ranks that hold this block: the axes its spec does not use.
        used = {a for e in specs[path] for a in (
            (e,) if isinstance(e, str) else (e or ()))}
        copies = math.prod(n for a, n in sizes.items() if a not in used)
        ref_d = w - t0
        leaf = {"dtype": str(got.dtype).removeprefix("torch."),
                "numel": got.numel() / copies,
                "moved": int((ref_d != 0).sum()) / copies,
                "ref": float(torch.linalg.vector_norm(ref_d)) ** 2 / copies}
        mesh_d = g - t0
        for name, d in (("mesh", mesh_d), ("zero", torch.zeros_like(t0)),
                        ("double", (t0 + 2 * mesh_d).to(got.dtype).float()
                         - t0)):
            leaf[name] = [float(torch.linalg.vector_norm(x)) ** 2 / copies
                          for x in (d, d - ref_d)]
            del d
        sums[path] = leaf
        del t0, ref_d, mesh_d
        if torch.equal(got, want):
            continue
        leaves += 1
        diff = (g - w).abs()
        elements += int((diff > 0).sum())
        worst = max(worst, float(diff.max()))
        close = close and torch.allclose(g, w, **TRAIN_SHARDED_TOL)
    return {"bitwise": leaves == 0, "leaves_differing": leaves,
            "elements_differing": elements, "max_abs_diff": worst,
            "close": close, "sums": sums}


def _update_compare(parts: list) -> dict:
    """The ranks' ``_shard_compare`` sums joined per leaf, over the leaves
    the one-process update ``Δ`` moves: per leaf its norm, share of moved
    elements, and for the mesh's update ``D`` the norm ratio ``|D| / |Δ|``
    and the relative difference ``|D - Δ| / |Δ|``; for the mesh and each control the worst leaf, and whether
    every leaf's ratio is within ``TRAIN_SHARDED_UPDATE_RATIO`` and its
    relative difference at most ``TRAIN_SHARDED_UPDATE_RTOL``."""
    total: dict = {}
    for part in parts:
        for path, leaf in part["sums"].items():
            acc = total.setdefault(path, {"dtype": leaf["dtype"]})
            for k, v in leaf.items():
                if k == "dtype":
                    continue
                if isinstance(v, list):
                    acc[k] = [a + b for a, b in zip(acc.get(k, [0.0] * 2),
                                                    v)]
                else:
                    acc[k] = acc.get(k, 0.0) + v
    moved = {p: t for p, t in total.items() if t["ref"] > 0}
    lo, hi = TRAIN_SHARDED_UPDATE_RATIO

    def stats(t, k):
        ratio, rel = (math.sqrt(x / t["ref"]) for x in t[k])
        return {"ratio": ratio, "rel": rel,
                "ok": lo <= ratio <= hi and rel <= TRAIN_SHARDED_UPDATE_RTOL}

    out = {"update_norm": math.sqrt(sum(t["ref"] for t in total.values())),
           "leaves": len(total), "leaves_moved": len(moved),
           "per_leaf": {p: {"dtype": t["dtype"], "norm": math.sqrt(t["ref"]),
                            "moved_share": t["moved"] / t["numel"],
                            **{k: v for k, v in stats(t, "mesh").items()
                               if k != "ok"}}
                        for p, t in moved.items()}}
    for k in ("mesh", "zero", "double"):
        per = {p: stats(t, k) for p, t in moved.items()}
        out[k] = {"close": all(v["ok"] for v in per.values()),
                  "ratio": [min(v["ratio"] for v in per.values()),
                            max(v["ratio"] for v in per.values())],
                  "rel_max": max(v["rel"] for v in per.values())}
    return out


def phase_train_sharded(torch, smi: str) -> dict:
    """The sharded training step (phase 14c): each run of
    ``TRAIN_SHARDED_RUNS`` once in this process on the whole parameters
    (the reference, saved to disk and freed while the ranks start), then
    all runs in one spawn of gloo ranks sharing the card, each on its
    mesh."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.launch.steps import build_step
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    refs = []

    def references():
        """The one-process rounds, while the ranks start: each saved where
        the ranks read it, then freed before they touch the card."""
        for run, path in zip(TRAIN_SHARDED_RUNS, paths):
            t_ref = time.perf_counter()
            sizes = dict(zip(MESH_AXES, run["mesh"]))
            plan = _sharded_train_plan(run, sizes)
            fn, args = build_step(plan, dev, seed=TRAIN_SHARDED_SEED)
            args = _flat_args(args)
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            (new, metrics), ref_s = _sync_s(torch, lambda: fn(*args))
            ref = {"plan": plan, "sizes": sizes, "ref_s": ref_s,
                   "launches": ops.launch_counts(),
                   "peak": torch.cuda.max_memory_allocated(),
                   "groups": len(args[0].flats),
                   "n_params": sum(f.numel() for f in args[0].flats.values()),
                   "metrics": {k: getattr(metrics, k).cpu()
                               for k in metrics._fields}}
            torch.save({k: v.cpu() for k, v in new.items()}, path)
            del fn, args, new, metrics
            torch.cuda.empty_cache()
            ref["one_process_s"] = time.perf_counter() - t_ref
            refs.append(ref)

    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"ref{i}.pt")
                 for i in range(len(TRAIN_SHARDED_RUNS))]
        spawned = time.perf_counter()
        res = run_on_mesh(_train_sharded_ranks, TRAIN_SHARDED_RUNS[0]["mesh"],
                          MESH_AXES, backend="gloo", device="cuda:0",
                          args=(TRAIN_SHARDED_RUNS, paths),
                          timeout_s=TRAIN_SHARDED_TIMEOUT_S,
                          meanwhile=references)
        mesh_s = time.perf_counter() - spawned
    launches = {}
    for i, (run, ref) in enumerate(zip(TRAIN_SHARDED_RUNS, refs)):
        plan, sizes, groups = ref["plan"], ref["sizes"], ref["groups"]
        ref_m, ref_launches = ref["metrics"], ref["launches"]
        res_i = [r[i] for r in res if r[i] is not None]
        parts = [r["vs_one_process"] for r in res_i]
        cmp = {"bitwise": all(c["bitwise"] for c in parts),
               "leaves_differing": sum(c["leaves_differing"] for c in parts),
               "elements_differing": sum(c["elements_differing"]
                                         for c in parts),
               "max_abs_diff": max(c["max_abs_diff"] for c in parts),
               "close": all(c["close"] for c in parts)}
        upd = _update_compare(parts)
        r0 = res_i[0]
        loss, loss_ref = float(r0["metrics"]["loss"]), float(ref_m["loss"])
        emit({"phase": "train_sharded", "arch": run["arch"],
              "mesh": sizes, "backend": "gloo", "ranks_share": "cuda:0",
              "policy": r0["policy"], "W": r0["W"], "P": r0["P"],
              "S": plan.S, "b": plan.b, "seq_len": plan.seq_len,
              "n_layers": plan.cfg.n_layers, "params": ref["n_params"],
              "worker_axes": r0["worker_axes"],
              "batch_axes": r0["batch_axes"], "dispatch": r0["dispatch"],
              "attn_impl": plan.cfg.attn_impl, "remat": plan.cfg.remat,
              "loss_chunk": plan.cfg.loss_chunk, "dtype_groups": groups,
              "loss": loss, "loss_one_process": loss_ref,
              "vs_one_process": cmp, "update_vs_one_process": upd,
              "tolerance": {
                  **TRAIN_SHARDED_TOL, "loss_rtol": TRAIN_SHARDED_LOSS_RTOL,
                  "update_ratio": TRAIN_SHARDED_UPDATE_RATIO,
                  "update_rtol": TRAIN_SHARDED_UPDATE_RTOL},
              "one_process": {"round_ms": ref["ref_s"] * 1e3,
                              "peak_bytes": ref["peak"],
                              "launches": ref_launches},
              "expert_split": r0["expert_split"],
              "ranks": [{k: r[k] for k in (
                  "coords", "param_bytes", "init_s", "round_ms", "gloo_ms",
                  "gloo_share", "wire_bytes", "wire_bytes_axis",
                  "expert_gathers_model", "peak_bytes", "launches")}
                  for r in res_i],
              "rank_s": max(r["left"] - r["entered"] for r in res_i),
              "one_process_s": ref["one_process_s"], "card": smi})
        want_k1 = groups * plan.S
        check(ref_launches["fedavg_accum"] == want_k1,
              f"{run['arch']} one process: K1 launched "
              f"{ref_launches['fedavg_accum']} times, not {want_k1}")
        for r in res_i:
            tag = f"{run['arch']} rank {r['coords']}"
            check(r["param_bytes"] == r["param_bytes_specs"],
                  f"{tag}: {r['param_bytes']} parameter bytes, the plan "
                  f"gives {r['param_bytes_specs']}")
            check(r["dispatch"] == run["dispatch"],
                  f"{tag}: the dispatch {'not ' * run['dispatch']}used")
            check(r["expert_split"] == bool(plan.cfg.moe),
                  f"{tag}: the plan's act_shard_moe split "
                  f"{'not ' * bool(plan.cfg.moe)}set")
            check(not r["expert_gathers_model"],
                  f"{tag}: expert leaves all-gathered over model: "
                  f"{r['expert_gathers_model']}")
            check(r["launches"]["fedavg_accum"] == want_k1
                  and sum(r["launches"].values()) == want_k1,
                  f"{tag}: launched {r['launches']}, K1 {want_k1} times "
                  f"and nothing else expected")
            check(bool(torch.isfinite(r["metrics"]["loss"])),
                  f"{tag}: loss {r['metrics']['loss']}")
            for k in ("steps", "clients", "total_weight"):
                check(torch.equal(r["metrics"][k], ref_m[k]),
                      f"{tag}: {k} {r['metrics'][k]}, one process "
                      f"{ref_m[k]}")
            check(torch.equal(r["metrics"]["loss"], r0["metrics"]["loss"]),
                  f"{tag}: its loss differs from rank 0's")
        # The update check must be able to fail: a rank that left θ as it
        # was, or doubled its update, is not close.
        check(upd["leaves_moved"] > 0 and not upd["zero"]["close"]
              and not upd["double"]["close"],
              f"{run['arch']}: the update check cannot tell a missing or "
              f"doubled update: {upd}")
        check(cmp["close"] and upd["mesh"]["close"]
              and abs(loss - loss_ref) <= TRAIN_SHARDED_LOSS_RTOL
              * abs(loss_ref),
              f"{run['arch']} mesh vs one process: {cmp}, update {upd}, "
              f"loss {loss} vs {loss_ref}")
        name = run["arch"] if run["dispatch"] or not plan.cfg.moe \
            else f"{run['arch']} no dispatch"
        launches[name] = [r["launches"] for r in res_i]
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "train_sharded_summary", "phase_s": phase_s,
          "mesh_s": mesh_s, "references_s": sum(r["one_process_s"]
                                                for r in refs),
          "card": smi})
    return {"launches": launches, "phase_s": phase_s}


def _mesh_compare(torch, ref: dict, got: dict, cfg, n_moe: int) -> dict:
    """The mesh run's logits ``[b, 1 + steps, vocab]`` against the one
    process's, on the (sequence, position) pairs whose routes and kept
    slots agree at every MoE layer in both runs and whose inputs are the
    same (every token generated before them agrees): the prefill's last
    position at ``MOE_BF16_TOL``, all positions at
    ``HYBRID_DECODE_BF16_TOL``; with the counts left out."""
    b = ref["logits"].shape[0]
    s = SERVE_PROMPT
    steps = ref["logits"].shape[1] - 1
    ga = _route_grid(torch, ref["calls"], n_moe, b)["experts"]
    gb = _route_grid(torch, got["calls"], n_moe, b)["experts"]
    positions = list(range(s - 1, s + steps))
    differ = (ga != gb).any(-1)[:, :, positions].any(0)     # [b, P]
    same_tok = (got["generated"] == ref["generated"])        # [b, steps]
    inputs = torch.cat([torch.ones(b, 1, dtype=torch.bool),
                        same_tok.cumprod(1).bool()], dim=1)  # [b, P]
    held = ~differ & inputs
    out = {}
    for key, cols, tol in (("prefill", slice(0, 1), MOE_BF16_TOL),
                           ("prefill_decode", slice(None), 
                            HYBRID_DECODE_BF16_TOL)):
        h = held[:, cols]
        res = _compare(torch, got["logits"][:, cols][h],
                       ref["logits"][:, cols][h], tol)
        res.update(compared_tokens=int(h.sum()),
                   rerouted_tokens_skipped=int(differ[:, cols].sum()),
                   diverged_tokens_skipped=int((~inputs[:, cols]
                                                & ~differ[:, cols]).sum()))
        out[key] = res
    out["generated_tokens_equal"] = int(same_tok.sum())
    out["generated_tokens"] = same_tok.numel()
    out["routing_decisions_differ"] = int((ga != gb).any(-1).sum())
    out["routing_decisions"] = int(ga.shape[0] * ga.shape[1] * ga.shape[2])
    out["bitwise_equal_logits"] = bool(torch.equal(got["logits"],
                                                   ref["logits"]))
    return out


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
    ``attn_impl="dense"``, weights drawn on the card: 4 clips of
    1,500 random frame embeddings with 448-token prompts, one prefill
    (the encoder, then the decoder with its cross-attention k/v cached) and
    16 greedy decode steps, with the launch counts zeroed just before and
    read just after (no kernel: dense attention, the ``"xla"`` norms);
    finite logits; prefill + decode against a teacher-forced ``forward``
    (``SERVE_TOL``); ``attn_impl="pallas"`` raises ``NotImplementedError``
    before any launch, as in the reference."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.launch.steps import device_params
    dev = torch.device("cuda")
    cfg = _audio_cfg()
    params, init_s = _sync_s(torch, lambda: device_params(cfg, 0, dev))
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
    layers, bf16, ``attn_impl="pallas"``, weights drawn on the card
    (5.8 B drawn on the card): 4 requests of 256 random patch embeddings
    and 2,048 tokens, one prefill over their 2,304 positions (K4 exactly
    once per layer, all on its wgmma route) and 16 greedy decode steps
    from position 2,304 (no K4), with the launch counts zeroed just before
    and read just after; finite logits; then the pallas prefill against
    the dense one and prefill + decode against a teacher-forced
    ``forward`` (``SERVE_TOL``)."""
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.launch.steps import device_params
    dev = torch.device("cuda")
    cfg = _vlm_cfg()
    positions = _vlm_positions(cfg)
    params, init_s = _sync_s(torch, lambda: device_params(cfg, 0, dev))
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


def _frame_group(frames) -> str:
    """An allocation's group: its innermost frame under ``src/repro_torch/``
    (``path:line function``), else its innermost Python frame, else none
    (the allocation ran in C++ with no Python caller, as a backward's
    built-in autograd nodes do on the autograd engine's device thread)."""
    mark = "src/repro_torch/"
    for f in frames:
        path = f["filename"].replace("\\", "/")
        if mark in path:
            return f"{path.split(mark, 1)[1]}:{f['line']} {f['name']}"
    if frames:
        f = frames[0]
        return (f"(outside the port) {Path(f['filename']).name}:{f['line']}"
                f" {f['name']}")
    return "(no Python frame)"


def _peak_breakdown(torch, fn, label: str, top: int = 10) -> dict:
    """Where the allocator's peak of one untimed call of ``fn`` lies.  The
    call runs under ``torch.cuda.memory._record_memory_history`` (Python
    stacks of every allocation); the snapshot's trace of this device is
    replayed from the bytes allocated before the call (an allocation adds
    its block, a free request takes it away, as ``memory_allocated``
    counts them) to the instant the sum peaks, and the blocks live then are
    grouped by :func:`_frame_group`, the blocks live before the call as one
    group.  The groups must sum to within ``BREAKDOWN_RTOL`` of
    ``max_memory_allocated`` of the same call.  Emits and returns GB per
    group, largest first, and the largest blocks."""
    import gc
    record = torch.cuda.memory._record_memory_history
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    record("all", context="alloc", stacks="python",
           max_entries=HISTORY_ENTRIES, clear_history=True)
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        snap = torch.cuda.memory._snapshot()
    finally:
        record(None)
    peak = torch.cuda.max_memory_allocated()
    trace = snap["device_traces"][torch.cuda.current_device()]
    check(len(trace) < HISTORY_ENTRIES,
          f"{label}: {len(trace)} trace entries, the history overflowed")
    cur, best, at = base, base, -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            cur += e["size"]
            if cur > best:
                best, at = cur, i
        elif e["action"] == "free_requested":
            cur -= e["size"]
    live, before = {}, base
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_requested" \
                and live.pop(e["addr"], None) is None:
            before -= e["size"]
    groups = {"(live before the call)": before}
    for e in live.values():
        key = _frame_group(e.get("frames") or [])
        groups[key] = groups.get(key, 0) + e["size"]
    total = sum(groups.values())
    blocks = sorted(live.values(), key=lambda e: -e["size"])[:top]
    out = {"phase": "peak_breakdown", "call": label, "call_s": call_s,
           "peak_gb": peak / 1e9, "replayed_peak_gb": best / 1e9,
           "groups_sum_gb": total / 1e9, "before_call_gb": base / 1e9,
           "trace_entries": len(trace), "peak_at_entry": at,
           "groups_gb": [[round(v / 1e9, 4), k] for k, v in
                         sorted(groups.items(), key=lambda kv: -kv[1])],
           "largest_blocks_gb": [[round(e["size"] / 1e9, 4),
                                  _frame_group(e.get("frames") or [])]
                                 for e in blocks]}
    emit(out)
    check(abs(total - peak) <= BREAKDOWN_RTOL * peak,
          f"{label}: the groups sum to {total} B, the allocator's peak is "
          f"{peak} B")
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
    step; the MoE arch's loss holds its load-balance term, and the peak of
    one more of its rounds is broken down."""
    import gc
    from repro_torch.launch.train import build_engine, lm_config
    out = {}
    for arch, rounds in LM_TRAIN:
        argv = ["--arch", arch, "--preset", "fl100m", "--rounds", str(rounds),
                "--steps-cap", str(LM_STEPS_CAP)]
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
    # The MoE arch's engine built as the CLI builds it (build_engine's
    # defaults), one round at depth 1 broken down.
    eng = build_engine(arch=MOE_ARCH, preset="fl100m")
    _peak_breakdown(torch, lambda: eng.run(1),
                    f"train_lm {MOE_ARCH} fl100m: one round at depth 1")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_lm_mesh(torch) -> dict:
    """The fl100m qwen3 on the mesh path (4 workers over 2 shards, tree
    combine, int8 uploads) at depths 1 and 0: bit-identical losses, K2
    once per live shard per round over the LM's leaf table, K1 once per
    worker-program step."""
    from repro_torch.launch.train import lm_config
    argv = (["--arch", SERVE_ARCH, "--preset", "fl100m", "--rounds",
             str(LM_MESH_ROUNDS), "--steps-cap", str(LM_STEPS_CAP)]
            + LM_MESH_ARGS)
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
    ``exec_time``, a profiled third round at depth 1, and a fourth whose
    peak is broken down (``_peak_breakdown``)."""
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
            _peak_breakdown(torch, lambda: eng.run(1),
                            "train_full: one more round at depth 1")
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
    from repro_torch.kernels import ref, work
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
    w = work.fedavg_accum(acc.shape, acc.dtype)
    nbytes = w.bytes
    bytes_ms = nbytes / mem_bw(device_name) * 1e3
    ops_ms = w.flops / peak_flops(w.dtype) * 1e3
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


def phase_train_full_mesh(torch) -> dict:
    """qwen3-0.6b at its published widths and dtypes through
    ``build_engine(lm_cfg=get_arch(...))`` on the tree + int8 mesh
    (``FULL_MESH``): 2 rounds at depths 1 and 0, bit-identical losses, the
    params bf16 and f32 after every round, K1 once per dtype group per
    worker-program step, K2 once per shard a round over the f32 twin of
    all 13 leaves, ``combine_bytes`` 2 × the int8 payload; ``exec_time``
    per round and the allocator's peak, and the peak of one more round at
    depth 1 broken down (``_peak_breakdown``)."""
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.layout import flatten_tree
    from repro_torch.launch.train import PRESETS, build_engine
    cfg = get_arch(SERVE_ARCH)
    shards = FULL_MESH["mesh_workers"]
    runs = {}
    for depth in (1, 0):
        t0 = time.perf_counter()
        eng = build_engine(lm_cfg=cfg, pipeline_depth=depth, **FULL_MESH)
        build_s = time.perf_counter() - t0
        groups = {}
        for leaf in flatten_tree(eng.params).values():
            key = str(leaf.dtype).removeprefix("torch.")
            n_leaves, n_vals = groups.get(key, (0, 0))
            groups[key] = (n_leaves + 1, n_vals + leaf.numel())
        del leaf
        check(groups == FULL_LEAVES, f"qwen3-0.6b leaves by dtype: {groups}")
        worker_steps, dtypes = [], []

        def observe(prep, result, eng=eng):
            worker_steps.append(sum(p[4][1].shape[-1]
                                    for p in prep.worker_programs
                                    if p[4] is not None))
            dtypes.append(sorted({str(v.dtype) for v in
                                  flatten_tree(eng.params).values()}))

        eng._round_observer = observe
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()     # the model, and any leftover
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = eng.run(FULL_MESH_ROUNDS)
        launches = ops.launch_counts()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        for r in res:
            emit({"phase": "train_full_mesh", "depth": depth,
                  "round": r.round_idx, "loss": r.loss, "s_steps": r.s_steps,
                  "padded_steps": r.padded_steps,
                  "exec_time": r.exec_time, "wall_time": r.wall_time,
                  "pack_time": r.pack_time, "combine_bytes": r.combine_bytes,
                  "residual_norm": r.residual_norm})
        losses = [r.loss for r in res]
        check(all(math.isfinite(x) for x in losses),
              f"full-width mesh depth {depth}: losses {losses}")
        check(dtypes == [["torch.bfloat16", "torch.float32"]]
              * FULL_MESH_ROUNDS, f"full-width mesh: param dtypes {dtypes}")
        check(launches["fedavg_accum"] == 2 * sum(worker_steps),
              f"full-width mesh: K1 launched {launches['fedavg_accum']} "
              f"times for 2 dtype groups x {sum(worker_steps)} "
              f"worker-program steps")
        check(launches["dequant_merge"] == shards * FULL_MESH_ROUNDS,
              f"full-width mesh: K2 launched {launches['dequant_merge']}, "
              f"want {shards} a round")
        check(all(r.combine_bytes == shards * FULL_INT8_PAYLOAD
                  for r in res), f"full-width mesh: combine_bytes "
              f"{[r.combine_bytes for r in res]}")
        _finite_params(torch, eng)
        if depth == 1:
            eng._round_observer = None
            _peak_breakdown(torch, lambda: eng.run(1),
                            "train_full_mesh: one more round at depth 1")
        runs[depth] = {"losses": losses, "launches": launches,
                       "worker_program_steps": worker_steps,
                       "allocated_before_bytes": held, "peak_bytes": peak,
                       "exec_time": [r.exec_time for r in res],
                       "wall_time": [r.wall_time for r in res],
                       "build_s": build_s}
        del eng, res, observe
        gc.collect()
        torch.cuda.empty_cache()
    check(runs[1]["losses"] == runs[0]["losses"],
          f"full-width mesh: depth 1 and 0 losses differ: "
          f"{runs[1]['losses']} vs {runs[0]['losses']}")
    out = {"launches": runs[1]["launches"],
           "peak_gb": runs[1]["peak_bytes"] / 1e9,
           "exec_time": runs[1]["exec_time"],
           "combine_bytes_per_round": shards * FULL_INT8_PAYLOAD}
    emit({"phase": "train_full_mesh_summary", "arch": SERVE_ARCH,
          "n_params": SERVE_PARAMS, "leaves": FULL_LEAVES, **FULL_MESH,
          "seq_len": PRESETS[FULL_MESH["preset"]]["seq_len"],
          "batch": PRESETS[FULL_MESH["preset"]]["batch_size"],
          "rounds": FULL_MESH_ROUNDS, "bit_identical_depth_0_1": True,
          "reduced": {"rounds": FULL_MESH_ROUNDS},
          "depth1": runs[1], "depth0": runs[0], **out})
    return out


def phase_k2_full(torch, device_name: str) -> dict:
    """K2 on one shard's fold of the full-width qwen3-0.6b payload: the f32
    twin of its 13 leaves, ``[596,180,992]``, one scale a leaf; bitwise
    against its plain version at the weight edges, then timed with it
    beside the bytes bound.  Inputs are drawn on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import dequant_merge as dm
    from repro_torch.kernels import ops, ref, work
    from repro_torch.kernels.layout import FlatLayout
    shapes = _lm_shapes(get_arch(SERVE_ARCH))
    twin = FlatLayout({k: torch.empty(s, device="meta")
                       for k, s in shapes.items()})
    n = twin.n
    check(n == SERVE_PARAMS and len(twin.names) == 13,
          f"full-width twin: {n} values in {len(twin.names)} leaves")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    acc = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev)
    q = torch.randint(-127, 128, (n,), generator=gen, device=dev,
                      dtype=torch.int8)
    scales = torch.rand(len(twin.names), generator=gen, device=dev) * 0.02
    offsets = twin.offsets_on(dev)
    err = 0.0
    for edge in EDGES:
        n_old, n_k = (torch.tensor(w, device=dev) for w in edge)
        got = ops.dequant_merge_flat(acc, q, g, scales, offsets, n_old, n_k)
        want = ref.dequant_merge_flat_ref(acc, q, g, scales, offsets,
                                          n_old, n_k)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        check(torch.equal(got, want), f"K2 full-width payload {edge}: "
                                      f"max err {err}")
        del got, want
    n_old = torch.tensor(6.0, device=dev).reshape(1)
    n_k = torch.tensor(3.0, device=dev).reshape(1)
    runs = {"kernel": lambda: dm.dequant_merge_flat(acc, q, g, scales,
                                                    offsets, n_old, n_k),
            "plain": lambda: ref.dequant_merge_flat_ref(
                acc, q, g, scales, offsets, n_old, n_k)}
    best = _best_of(runs, (("kernel", "plain"), ("plain", "kernel"),
                           ("kernel", "plain")), iters=10)
    w = work.dequant_merge(n)
    bytes_ms = w.bytes / mem_bw(device_name) * 1e3
    ops_ms = w.flops / peak_flops(w.dtype) * 1e3
    out = {"shape": [n], "leaves": len(twin.names), "max_abs_err": err,
           "ms": best["kernel"], "plain_ms": best["plain"],
           "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": w.bytes}
    out["roofline_share"] = out["bound_ms"] / best["kernel"]
    emit({"phase": "timing", "kernel": "dequant_merge",
          "path": "train LM full width, mesh", **out})
    del acc, g, q
    torch.cuda.empty_cache()
    return out


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
    memory, a profiled round (MLM: and one more whose peak is broken down),
    and K1 timed at the task's ``[4, N]`` lane buffer beside its plain
    version, ``torch.lerp`` and the bound."""
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
                if task == "mlm":
                    _peak_breakdown(torch, lambda: eng.run(1),
                                    "train_tasks mlm: one more round at "
                                    "depth 1")
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


def _dry_launches(dry: dict, arch: str, shape: str, kernel: str) -> int:
    return dry["runs"][(arch, shape)]["run"]["launches"][kernel]


def dryrun_pool_start():
    """Count DRYRUN_RUNS' cells at their overrides and every runnable cell
    at its plan on meta tensors, in DRYRUN_WORKERS spawned processes at the
    lowest priority; returns ``(pool, {(arch, shape, tag): result})``, tag
    ``"run"`` for the former.  Those go first, then train cells and large
    archs, so the longest counts start first."""
    import multiprocessing as mp

    from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch
    from repro_torch.launch import dryrun, plan
    cells = [(a, s) for a in ARCH_NAMES for s in SHAPES
             if plan.runnable(get_arch(a), s)]
    cells.sort(key=lambda c: (c[1] != "train_4k",
                              -plan.param_bytes(get_arch(c[0]))))
    pool = mp.get_context("spawn").Pool(DRYRUN_WORKERS, initializer=os.nice,
                                         initargs=(19,))
    pending = {(a, s, "run"): pool.apply_async(
        dryrun.run_cell, (a, s), {"overrides": over or None})
        for a, s, over in DRYRUN_RUNS}
    pending.update({(a, s, ""): pool.apply_async(dryrun.run_cell, (a, s))
                    for a, s in cells})
    return pool, pending


def _dryrun_fold(torch, arch: str, shape: str, over: dict) -> dict:
    """K1 against its plain version at the train cell's own calls: each
    dtype group's ``[L, n_g]`` lane buffer (``L = W·P``) with ``[L]``
    weights over EDGES; bf16 within 1 ulp, f32 bitwise."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.layout import FlatLayout, flatten_tree
    from repro_torch.launch import plan
    pl = plan.make_plan(arch, shape, overrides=over)
    lanes = pl.W * pl.P
    layout = FlatLayout(flatten_tree(plan.meta_params(pl.cfg)))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for key, group in zip(layout.keys, layout.groups):
        dtype = group.dtypes[0]
        acc, theta = (torch.randn(lanes, group.n, generator=gen, device=dev)
                      .to(dtype) for _ in range(2))
        worst = 0
        for n_old, n_k in EDGES:
            n_old = torch.full((lanes,), n_old, device=dev)
            n_k = torch.full((lanes,), n_k, device=dev)
            got = ops.fedavg_accum(acc, theta, n_old, n_k)
            want = ref.fedavg_accum_ref(acc, theta, n_old, n_k)
            if dtype == torch.float32:
                check(torch.equal(got, want), f"K1 f32 [{lanes}, {group.n}]"
                                              f": max err "
                                              f"{_max_err(torch, got, want)}")
            else:
                worst = max(worst, _bf16_ulps(torch, got, want))
                check(worst <= 1, f"K1 {dtype} [{lanes}, {group.n}]: "
                                  f"{worst} ulps")
            del got, want
        out[key] = {"shape": [lanes, group.n], "cases": len(EDGES),
                    "ulps": worst}
        del acc, theta
    torch.cuda.empty_cache()
    return out


def _dryrun_kernels(torch, device_name: str) -> dict:
    """K4 at qwen3's 32k prompt against its plain version one kv head at a
    time (its scores ``[1, 2, 32768, 32768]`` f32 take 8.6 GB a head; all
    16 heads' 68.7 GB) and against one SDPA call, within
    SERVE_ATTN_BF16_TOL; K5 at mamba2's against its plain version; each
    timed (K4 beside SDPA, K5 beside its plain version) with its bound
    from ``kernels/work.py``."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ops, ref, work
    from repro_torch.kernels import ssd as k5
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(21)
    b, s, hq, hkv, d = K4_32K
    g = hq // hkv
    q = torch.randn(b, s, hq, d, generator=gen).to(torch.bfloat16).to(dev)
    k = torch.randn(b, s, hkv, d, generator=gen).to(torch.bfloat16).to(dev)
    v = torch.randn(b, s, hkv, d, generator=gen).to(torch.bfloat16).to(dev)
    runs = {"kernel": lambda: fl.flash_attention_bshd(q, k, v, causal=True,
                                                      t_pad=s),
            "library": lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)}
    got = runs["kernel"]()
    err_plain = 0.0
    for h in range(hkv):
        heads = slice(h * g, (h + 1) * g)
        want = ref.flash_attention_bshd_ref(
            q[:, :, heads], k[:, :, h:h + 1], v[:, :, h:h + 1], causal=True,
            t_pad=s)
        err_plain = max(err_plain, _max_err(torch, got[:, :, heads], want))
        check(_close(torch, got[:, :, heads], want, **SERVE_ATTN_BF16_TOL),
              f"K4 at {list(K4_32K)}, kv head {h}: max err {err_plain} over "
              f"{SERVE_ATTN_BF16_TOL}")
        del want
        torch.cuda.empty_cache()
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        lib = runs["library"]().transpose(1, 2)
        err = _max_err(torch, lib, got)
        check(_close(torch, got, lib, **SERVE_ATTN_BF16_TOL),
              f"K4 at {list(K4_32K)} against SDPA: max err {err}")
        del lib, got
        best = _best_of(runs, (("kernel", "library"), ("library", "kernel"),
                               ("kernel", "library")), iters=5, warmup=1)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    w = work.flash_attention(q.shape, k.shape, q.dtype, causal=True)
    bytes_ms = w.bytes / mem_bw(device_name) * 1e3
    ops_ms = w.flops / peak_flops(w.dtype) * 1e3
    out = {"flash_attention": {
        "shape_q": list(q.shape), "shape_kv": list(k.shape),
        "ms": best["kernel"], "plain_ms": None,
        "library_ms": best["library"], "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "max_abs_err": err_plain, "library_vs_kernel_max_abs_diff": err}}
    del q, k, v
    args = _ssd_inputs(torch, SSD_32K, torch.bfloat16, gen, model_like=True)
    ck = ops.ssd_chunk(SSD_32K[1], SSD_32K[6])
    runs = {"kernel": lambda: k5.ssd_bshp(*args, chunk=ck, want_state=True),
            "plain": lambda: ref.ssd_chunks_ref(*args, chunk=ck)}
    y, state = runs["kernel"]()
    want_y, want_state = runs["plain"]()
    check(_close(torch, y, want_y, **SSD_TOL["bfloat16"])
          and _close(torch, state, want_state, **SSD_TOL["bfloat16"]),
          f"K5 at {list(SSD_32K)}: max err {_max_err(torch, y, want_y)}")
    best = _best_of(runs, (("kernel", "plain"), ("plain", "kernel"),
                           ("kernel", "plain")), iters=5, warmup=1)
    x, dt, B = args[0], args[1], args[3]
    w = work.ssd(x.shape, B.shape, x.dtype, dt.dtype, chunk=ck, state=True)
    bytes_ms = w.bytes / mem_bw(device_name) * 1e3
    ops_ms = w.flops / peak_flops(w.dtype) * 1e3
    out["ssd"] = {"shape": list(SSD_32K), "ms": best["kernel"],
                  "plain_ms": best["plain"], "library_ms": None,
                  "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms
                  else "operations",
                  "max_abs_err_y": _max_err(torch, y, want_y)}
    for row in out.values():
        row["roofline_share"] = row["bound_ms"] / row["ms"]
    emit({"phase": "dryrun_kernels", **out})
    del args, y, state, want_y, want_state
    torch.cuda.empty_cache()
    return out


def phase_dryrun(torch, pool, pending: dict, device_name: str, smi: str,
                 out_dir: str | None) -> dict:
    """The dry-run: the four DRYRUN_RUNS cells, counted by the background
    pool, measured on the card by ``dryrun.measure_cell`` (the count must
    say it fits, the run must not run out of memory nor past the counted
    peak by more than DRYRUN_PEAK_RTOL, its outputs must be finite, its
    launches DRYRUN_LAUNCHES' and its counted matrix-product FLOPs within
    DRYRUN_FLOPS_RTOL of the profiler's); K1 at the train cell's groups,
    K4 and K5 at 32k positions, each against its plain version; then every
    other count of the pool (32 cells ok, or failed with the op named) and
    the 8 declared skips."""
    from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch
    from repro_torch.launch import dryrun, plan
    t0 = time.perf_counter()
    runs = {}
    for arch, shape, over in DRYRUN_RUNS:
        torch.cuda.empty_cache()
        rec = pending.pop((arch, shape, "run")).get(timeout=1200)
        check(rec["status"] == "ok", f"dry-run {arch} {shape}: {rec}")
        m = rec["run"] = dryrun.measure_cell(rec, device="cuda")
        want = DRYRUN_LAUNCHES[(arch, shape)]
        got = {k: v for k, v in m["launches"].items() if v}
        emit({"phase": "dryrun_run", "arch": arch, "shape": shape,
              "overrides": over, "card": smi, "W": rec["W"], "P": rec["P"],
              "S": rec["S"], "b": rec["b"], "fits": rec["fits"],
              "predicted_peak_gb": m["predicted_peak_bytes"] / 1e9,
              "peak_gb": m["peak_bytes"] / 1e9, "step_s": m["step_s"],
              "warmup_s": m["warmup_s"],
              "bound_s": rec["roofline"]["step_lower_bound_s"],
              "dominant": rec["roofline"]["dominant"],
              "compute_s": rec["roofline"]["compute_s"],
              "memory_s": rec["roofline"]["memory_s"],
              "roofline_fraction": m["roofline_fraction"], "mfu": m["mfu"],
              "gflops": rec["flops_per_device"] / 1e9,
              "gb": rec["bytes_per_device"] / 1e9,
              "model_gflops": rec["model_flops_total"] / 1e9,
              "useful_ratio": rec["useful_ratio"], "launches": got,
              "routes": m["routes"], "kernels_counted": rec["kernels"],
              "profiled_kernels": m["profiled_kernels"],
              "profiled_call": m["profiled_call"],
              "profiled_busy_ms": m["profiled_busy_ms"],
              "top_kernels": m["top_kernels"][:6],
              "matmul_flops_counted": m["matmul_flops_counted"],
              "matmul_flops_profiled": m["matmul_flops_profiled"],
              "matmul_flops_rel_diff": m["matmul_flops_rel_diff"],
              "finite": m["finite"]})
        check(rec["fits"], f"dry-run {arch} {shape}: the count says it does "
                           f"not fit ({m['predicted_peak_bytes']} B)")
        check(m["peak_bytes"] <= (1 + DRYRUN_PEAK_RTOL)
              * m["predicted_peak_bytes"],
              f"dry-run {arch} {shape}: peak {m['peak_bytes']} B past the "
              f"counted {m['predicted_peak_bytes']} B")
        check(m["finite"], f"dry-run {arch} {shape}: non-finite outputs")
        check(got == want, f"dry-run {arch} {shape}: launches {got}, want "
                           f"{want}")
        for kernel, n in want.items():
            if kernel in m["routes"]:
                check(m["routes"][kernel]["wgmma"] == n,
                      f"dry-run {arch} {shape}: {kernel} routes "
                      f"{m['routes'][kernel]}")
        check(m["matmul_flops_rel_diff"] <= DRYRUN_FLOPS_RTOL,
              f"dry-run {arch} {shape}: counted matmul FLOPs "
              f"{m['matmul_flops_counted']} vs profiled "
              f"{m['matmul_flops_profiled']}")
        runs[(arch, shape)] = rec
    fold = _dryrun_fold(torch, *DRYRUN_RUNS[0])
    kernels = _dryrun_kernels(torch, device_name)
    emit({"phase": "dryrun_fold", "card": smi, **fold})
    run_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    records = []
    for (arch, shape, _), res in pending.items():
        rec = res.get(timeout=1200)
        records.append(rec)
        row = {"phase": "dryrun_cell", "arch": arch, "shape": shape,
               "status": rec["status"]}
        if rec["status"] == "ok":
            row.update(plan=[rec["W"], rec["P"], rec["S"], rec["b"]],
                       fits=rec["fits"],
                       peak_gb=rec["memory_analysis"]["peak_live_bytes"]
                       / 1e9, gflops=rec["flops_per_device"] / 1e9,
                       gb=rec["bytes_per_device"] / 1e9,
                       dominant=rec["roofline"]["dominant"],
                       bound_s=rec["roofline"]["step_lower_bound_s"],
                       useful_ratio=rec["useful_ratio"],
                       kernels={k: v["calls"]
                                for k, v in rec["kernels"].items()},
                       count_s=rec["count_s"])
        else:
            row["op"] = rec.get("op")
        emit(row)
    pool.close()
    pool.join()
    skips = [dryrun.skip_record(a, s) for a in ARCH_NAMES for s in SHAPES
             if not plan.runnable(get_arch(a), s)]
    for rec in skips:
        emit({"phase": "dryrun_cell", **rec})
    ok = [r for r in records if r["status"] == "ok"]
    failed = [r for r in records if r["status"] != "ok"]
    check(len(records) == 32 and len(skips) == 8,
          f"dry-run: {len(records)} counted cells, {len(skips)} skips")
    check(all(r.get("op") for r in failed),
          f"dry-run: a cell failed without naming its op: {failed}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        named = [(r, "") for r in records + skips] + \
            [(r, "__run") for r in runs.values()]
        for rec, tag in named:
            path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}"
                                         f"{tag}.json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    out = {"runs": runs, "kernels": kernels, "fold": fold, "ok": len(ok),
           "failed": [(r["arch"], r["shape"], r["op"]) for r in failed],
           "skips": len(skips), "run_s": run_s,
           "collect_s": time.perf_counter() - t1}
    emit({"phase": "dryrun", "counted_ok": len(ok),
          "counted_failed": out["failed"], "skipped": len(skips),
          "fits": sum(bool(r["fits"]) for r in ok), "run_s": run_s,
          "collect_s": out["collect_s"],
          "count_s_total": sum(r["count_s"] for r in ok)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--profile-out", default=None)
    ap.add_argument("--dryrun-out", default=None,
                    help="write every dry-run record there as JSON")
    args = ap.parse_args()

    import torch
    from repro_torch.launch.train import set_deterministic
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    set_deterministic()
    smi = phase_probe(torch)
    sass, sass5 = phase_build()
    pool, pending = dryrun_pool_start()
    try:
        return _phases(torch, args, smi, sass, sass5, pool, pending)
    finally:
        pool.terminate()
        pool.join()


def _phases(torch, args, smi, sass, sass5, pool, pending) -> int:
    """Every phase after the build, while the dry-run pool counts."""
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
    timing4_hyb = phase_timing_k4(torch, name, _hybrid_cfg())
    timing4_rank = phase_timing_k4(torch, name, _hybrid_rank_cfg())
    timing5 = phase_timing_k5(torch, name)
    timing5_hyb = phase_timing_k5(torch, name, SSD_HYBRID)
    timing5_rank = phase_timing_k5(torch, name, SSD_HYBRID_RANK)
    clock("check, timing")
    launches, steps, res = phase_main(torch, args.rounds)
    mesh_launches, mesh_res = phase_mesh(torch, MESH_ROUNDS)
    phase_decomposition(torch)
    phase_agree(torch)
    clock("main, mesh, decomposition, agree")
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
                       (HYBRID_ARCH, {"ssd_impl": "pallas"})):
        phase_agree_lm(torch, arch, attn_impl="pallas", **impl)
    clock("serve, serve SSM, serve MoE")
    hybrid = phase_serve_hybrid(torch)
    phase_serve_profile(torch, hybrid, _hybrid_cfg(),
                        phase="serve_hybrid_profile",
                        groups={"k5": ("ssd_fwd",), **MOE_DISPATCH_KERNELS,
                                "gemm": GEMM_KERNELS})
    phase_serve_hybrid_f32(torch, hybrid)
    torch.cuda.empty_cache()
    clock("serve hybrid")
    hybrid["mesh_ref"]["tokens"] = hybrid["tokens"].cpu()
    del hybrid["tokens"], hybrid["generated"]
    torch.cuda.empty_cache()
    mesh = phase_serve_hybrid_mesh(torch, hybrid["mesh_ref"])
    clock("serve hybrid mesh")
    sharded = phase_train_sharded(torch, smi)
    clock("train sharded")
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
    clock("serve audio, serve VLM")
    train_lm = phase_train_lm(torch)
    clock("train LM")
    train_mesh = phase_train_lm_mesh(torch)
    torch.cuda.empty_cache()
    train_full = phase_train_full(torch)
    lm_fold = phase_lm_fold(torch, name)
    k2_lm = phase_k2_lm(torch, name)
    torch.cuda.empty_cache()
    full_mesh = phase_train_full_mesh(torch)
    k2_full = phase_k2_full(torch, name)
    phase_agree_train(torch)
    clock("train LM mesh, full width, full-width mesh, agree train")
    tasks = phase_train_tasks(torch, name)
    clock("train tasks")
    fedmedian = phase_fedmedian(torch)
    resume = phase_resume(torch)
    phase_agree_tasks(torch)
    control = phase_control(torch)
    population = phase_population(torch)
    memory = phase_memory_probe(torch)
    cache = phase_cache(torch)
    cache_mesh = phase_cache_mesh(torch)
    multihost = phase_multihost(torch)
    torch.cuda.empty_cache()
    clock("fedmedian ... multihost")
    dry = phase_dryrun(torch, pool, pending, name, smi, args.dryrun_out)
    clock("dryrun")
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
         "launches_train_full_mesh": full_mesh["launches"]["fedavg_accum"],
         "launches_train_sharded_per_rank": {
             a: [c["fedavg_accum"] for c in v]
             for a, v in sharded["launches"].items()},
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
             "bound_by", "max_abs_err")},
         "launches_dryrun": _dry_launches(dry, "qwen3-0.6b", "train_4k",
                                          "fedavg_accum"),
         "dryrun_fold": dry["fold"]},
        {**row("dequant_merge", "dequant_merge.cu",
               "src/repro/kernels/dequant_merge.py:46",
               mesh_launches["dequant_merge"], max_err2, timing2),
         "launches_per_round": mesh_launches["dequant_merge"] / len(mesh_res),
         "launches_train_lm_mesh": train_mesh["launches"]["dequant_merge"],
         "launches_train_full_mesh": full_mesh["launches"]["dequant_merge"],
         "launches_resume_mesh": resume["mesh_int8"]["launches_resumed"][
             "dequant_merge"],
         "launches_control_mesh": control["mesh"]["tree_int8"]["launches"][
             "dequant_merge"],
         "launches_cache_mesh": cache_mesh["depth1"]["launches"][
             "dequant_merge"],
         "lm_payload": {k: k2_lm[k] for k in (
             "shape", "leaves", "ms", "plain_ms", "bound_ms", "bound_by")},
         "full_width_payload": {k: k2_full[k] for k in (
             "shape", "leaves", "ms", "plain_ms", "bound_ms", "bound_by",
             "max_abs_err")},
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
         "launches_serve_hybrid": hybrid["launches"]["flash_attention"],
         "launches_by_route_serve_hybrid": hybrid["k4_routes_prefill"],
         "launches_serve_hybrid_mesh_per_rank": [
             c["flash_attention"] for c in mesh["launches"]],
         "launches_by_route_serve_hybrid_mesh_per_rank": [
             r["k4"] for r in mesh["routes"]],
         "serve_hybrid_shape": {k: timing4_hyb[k] for k in (
             "shape_q", "shape_kv", "ms", "plain_ms", "library_ms",
             "bound_ms", "bound_by")},
         "serve_hybrid_mesh_rank_shape": {k: timing4_rank[k] for k in (
             "shape_q", "shape_kv", "ms", "plain_ms", "library_ms",
             "bound_ms", "bound_by")},
         "launches_dryrun": _dry_launches(dry, "qwen3-0.6b", "prefill_32k",
                                          "flash_attention"),
         "dryrun_32k": dry["kernels"]["flash_attention"],
         "path": "serve (qwen3-0.6b, granite-moe-3b-a800m, internvl2-26b "
                 "and jamba-v0.1-52b prefill, attn_impl='pallas'; jamba's "
                 "also on each rank of a (1, 2) mesh, at its 16 heads)"},
        {**row("ssd", "ssd.cu", "src/repro/kernels/ssd.py:83",
               ssm["launches"]["ssd"], max(err5.values()), timing5),
         "launches_per_prefill": ssm["launches"]["ssd"],
         "launches_by_route": ssm["k5_routes_prefill"], "sass": sass5,
         "launches_serve_hybrid": hybrid["launches"]["ssd"],
         "launches_by_route_serve_hybrid": hybrid["k5_routes_prefill"],
         "launches_serve_hybrid_mesh_per_rank": [
             c["ssd"] for c in mesh["launches"]],
         "launches_by_route_serve_hybrid_mesh_per_rank": [
             r["k5"] for r in mesh["routes"]],
         "serve_hybrid_shape": {k: timing5_hyb[k] for k in (
             "shape", "ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by")},
         "serve_hybrid_mesh_rank_shape": {k: timing5_rank[k] for k in (
             "shape", "ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by")},
         "launches_dryrun": _dry_launches(dry, "mamba2-2.7b", "prefill_32k",
                                          "ssd"),
         "dryrun_32k": dry["kernels"]["ssd"],
         "path": "serve SSM and hybrid (mamba2-2.7b and jamba-v0.1-52b "
                 "prefill, ssd_impl='pallas'; jamba's also on each rank of "
                 "a (1, 2) mesh, at its 64 heads)"}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
