#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: the quickest proof that
the port still builds, agrees with itself and trains on the GPU.

    python3 chip_smoke.py [--rounds 4] [--profile-out DIR]

Phases, one JSON object per line on stdout:

1. probe   — Python, torch, CUDA, nvcc and the card (the raw
             ``nvidia-smi --query-gpu=name,power.limit`` line is printed on
             its own line as well);
2. build   — every kernel of the port compiled from ``src/repro_torch/
             kernels/csrc`` with nvcc (one process each, in parallel), with
             ptxas' report;
3. check   — each kernel against its plain PyTorch version on the card:
             K1 at the reference's test shapes, the SR leaf shapes and the
             flat lane buffer the round folds (f32 bitwise, bf16 within 1
             ulp); K2 at the reference's sweep shapes and weight edges and
             on the SR flat buffer with its 18-leaf scale table (f32
             bitwise; ``N+n == 0`` returns ``acc`` bit for bit);
4. timing  — each kernel, its plain version and, where one exists, one
             library call at the main path's shapes (CUDA events, best of
             3 interleaved), beside the bytes/ops bound;
5. main    — ``build_engine(task="sr")`` at the published SR widths on
             ``cuda``: rounds at pipeline depth 1 and again at depth 0 from
             the same seed, with the launch counts zeroed just before each
             run and read just after; losses must be finite and
             bit-identical, and every round step must have gone through K1;
6. mesh    — the slice's path, ``build_engine(task="sr", workers=4,
             mesh_workers=2, combine_mode="tree", combine_compress="int8")``
             at the published widths, ``MESH_ROUNDS`` rounds at depth 1
             and again at depth 0:
             finite losses, bit-identical across depths, K2 launched once
             per live shard per round, ``combine_bytes`` 2 × 4,245,072 B
             per round, K1 once per worker program step;
7. decomp  — the flat combine at ``mesh_workers`` 2 and 4 against the
             fused path (4 workers), bitwise; ``hosts=1`` against
             ``hosts=2`` at ``mesh_workers=4`` with ``combine_compress``
             ``none`` and ``int8``, bitwise; one topk round;
8. agree   — a small SR engine on the card against the same engine on the
             CPU (rtol 1e-4: GEMM sums are ordered differently);
9. the ``kernels`` line, then the card line and the last line
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


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    info = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"seconds": v["seconds"], "cached": v["cached"],
                             "ptxas": [ln.strip() for ln in
                                       v["log"].splitlines()
                                       if "registers" in ln or "spill" in ln]}
                      for name, v in info.items()}})


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
    best = {k: math.inf for k in runs}
    for order in (("kernel", "plain", "library"),
                  ("library", "plain", "kernel"),
                  ("kernel", "plain", "library")):
        for k in order:
            best[k] = min(best[k], time_ms(runs[k]))
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
    params, _ = make_task_model("sr", 0)
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
    best = {k: math.inf for k in runs}
    for order in (("kernel", "plain"), ("plain", "kernel"),
                  ("kernel", "plain")):
        for k in order:
            best[k] = min(best[k], time_ms(runs[k]))
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


def _finite_params(torch, eng) -> None:
    for k, v in eng.params.items():
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
        params, loss = make_task_model("sr", 0, width=64, n_blocks=2)
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
    rows, host = [], []  # kernels (an aten op's entry repeats its kernels')
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            if dev_us > 0:
                rows.append((dev_us, e.key, e.count))
        elif e.self_cpu_time_total > 0:
            host.append((e.self_cpu_time_total, e.key, e.count))
    rows.sort(reverse=True)
    host.sort(reverse=True)
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
    phase_build()
    name = torch.cuda.get_device_name(0)
    lanes, n_params = 4, SR_PARAMS       # 2 workers x 2 lanes, SR published
    max_err = phase_check(torch, n_params, lanes)
    layout = _sr_layout()
    max_err2 = phase_check_k2(torch, layout)
    timing = phase_timing(torch, n_params, lanes, name)
    timing2 = phase_timing_k2(torch, layout, name)
    launches, steps, res = phase_main(torch, args.rounds)
    mesh_launches, mesh_res = phase_mesh(torch, MESH_ROUNDS)
    phase_decomposition(torch)
    phase_agree(torch)
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
         "launches_mesh_path": mesh_launches["fedavg_accum"]},
        {**row("dequant_merge", "dequant_merge.cu",
               "src/repro/kernels/dequant_merge.py:46",
               mesh_launches["dequant_merge"], max_err2, timing2),
         "launches_per_round": mesh_launches["dequant_merge"] / len(mesh_res),
         "path": "mesh"}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
