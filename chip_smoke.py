#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: the quickest proof that
the port still builds, agrees with itself and trains on the GPU.

    python3 chip_smoke.py [--rounds 4] [--profile-out DIR]

Phases, one JSON object per line on stdout:

1. probe   — Python, torch, CUDA, nvcc and the card (the raw
             ``nvidia-smi --query-gpu=name,power.limit`` line is printed on
             its own line as well);
2. build   — every kernel of the port compiled from ``src/repro_torch/
             kernels/csrc`` with nvcc (in parallel), with ptxas' report;
3. check   — each kernel against its plain PyTorch version on the card, at
             the reference's test shapes, the SR leaf shapes and the flat
             lane buffer the round folds (f32 bitwise, bf16 within 1 ulp);
4. timing  — each kernel, its plain version and one library call at the
             main path's shapes (CUDA events), beside the bytes/ops bound;
5. main    — ``build_engine(task="sr")`` at the published SR widths on
             ``cuda``: rounds at pipeline depth 1 and again at depth 0 from
             the same seed, with the launch counts zeroed just before each
             run and read just after; losses must be finite and
             bit-identical, and every round step must have gone through K1;
6. agree   — a small SR engine on the card against the same engine on the
             CPU (rtol 1e-4: GEMM sums are ordered differently);
7. the ``kernels`` line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failed phase raises, so the script exits non-zero and prints no last
line.  It also fails where no CUDA card is present, and where the repo's
``src/`` is missing.  ``--profile-out DIR`` adds a torch.profiler pass over
two main-path rounds: the trace, per-kernel device time and per-op host
time, written to DIR.
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


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    for k, v in eng.params.items():
        check(bool(torch.isfinite(v).all()), f"param {k} not finite")
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
    check(n_params == 4_244_992, f"SR has {n_params} params, not 4,244,992")
    emit({"phase": "main_summary", "rounds": rounds, "losses": l1,
          "bit_identical_depth_0_1": True, "launches_depth1": k1,
          "launches_depth0": k0, "s_steps_total": steps1,
          "n_params": n_params, "n_leaves": len(eng1.params),
          "mean_exec_s": sum(r.exec_time for r in res1[1:])
          / max(len(res1) - 1, 1),
          "recompiles": res1[-1].recompiles})
    return k1["fedavg_accum"], steps1, res1


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


def phase_profile(torch, out_dir: str) -> None:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.train import build_engine
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    eng = build_engine(task="sr")
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
    emit({"phase": "profile", "rounds": 2, "wall_s": wall,
          "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall,
          "host_self_s": sum(r[0] for r in host) / 1e6,
          "top": [{"name": k[:80], "ms": us / 1e3, "count": n}
                  for us, k, n in rows[:12]],
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
    lanes, n_params = 4, 4_244_992       # 2 workers x 2 lanes, SR published
    max_err = phase_check(torch, n_params, lanes)
    timing = phase_timing(torch, n_params, lanes, torch.cuda.get_device_name(0))
    launches, steps, res = phase_main(torch, args.rounds)
    phase_agree(torch)
    if args.profile_out:
        phase_profile(torch, args.profile_out)
    emit({"kernels": [{
        "name": "fedavg_accum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_accum.cu",
        "replaces": "src/repro/kernels/fedavg_accum.py:41",
        "launches": launches, "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "launches_per_round": launches / len(res)}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
