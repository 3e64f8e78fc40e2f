"""The dry-run — port of ``repro/launch/dryrun.py`` for one card.

Counts every (architecture × input-shape) cell of the assignment on meta
tensors: the planned step (:mod:`repro_torch.launch.plan`,
:mod:`repro_torch.launch.steps`) runs once under the cost counter
(:mod:`repro_torch.launch.op_cost`), which gives its FLOPs (by dtype),
bytes, peak live bytes (does it fit the card?) and the hand-written
kernels' work; :mod:`repro_torch.launch.roofline` turns those into the
compute and memory terms.  Nothing is allocated, so every cell counts on
the host, the 235 B-parameter ones included.

With ``--run`` a cell also runs on the card at random weights from a seed:
the step's time (CUDA events, after a warm-up call), the allocator's peak,
the kernels' launches, device time by kernel from ``torch.profiler``, the
model-FLOPs share of the card's peak (``mfu``) and the roofline fraction
(the counted lower bound over the measured time).

With ``--mesh pod`` (or ``multipod``) a cell is counted per card of the
reference's production mesh, (16, 16) ("data", "model") or (2, 16, 16)
("pod", "data", "model"), on a ``"meta"`` mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`): the plan of that
mesh (workers, FSDP/TP policy, the expert-parallel dispatch), one card's
shards of the parameters and its block of the inputs (a serve cell's
batch and cache, a train cell's workers' batches), the step of one rank —
where ``model`` is no worker axis its layers split over ``model`` (the
rank's heads, MLP columns, Mamba heads, vocabulary, and a MoE layer's
experts — through the dispatch, or the ``act_shard_moe`` split without it
— or under ``tp`` each expert's ``F``; the residual stream over the
sequence under the large archs' sequence parallelism), each split layer's
weights gathered only over the FSDP axes, while a layer that does not
divide and cross-attention gather their layers whole, under remat again
in the backward — and the collectives it
runs (the gathers, the split products' all-reduces or reduce-scatters and
the sequence gathers, the gradient reductions, the cross-worker reduce of
the lane partials), their ring wire bytes turned into the roofline's
``collective_s``; ``fits`` is judged per card.  ``--mesh one``, the default, counts one card
holding everything, as before.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --set S=32 --set b=8 --run
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.report
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch
from repro_torch.core.concurrency import DeviceSpec
from repro_torch.launch.op_cost import (MATMUL_OPS, DataDependentOp,
                                        analyze_step)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.plan import (make_plan, param_bytes,
                                     param_bytes_per_card, runnable,
                                     skip_reason)
from repro_torch.launch.roofline import HW, model_flops, roofline_terms
from repro_torch.launch.steps import build_step, device_params

__all__ = ["run_cell", "measure_cell", "skip_record", "first_step",
           "parse_overrides", "main", "MESHES"]

MESHES = ("one", "pod", "multipod")

_PROFILED_MATMULS = tuple(f"aten::{n}" for n in MATMUL_OPS)


def skip_record(arch: str, shape: str, mesh: str = "one") -> dict:
    rec = {"arch": arch, "shape": shape, "status": "skip",
           "reason": skip_reason(get_arch(arch), shape)}
    if mesh != "one":
        rec["mesh"] = mesh
    return rec


def first_step(plan, args: tuple) -> tuple:
    """A train step's inputs cut to the first local step of every lane
    (``S = 1``: the warm-up and the profiled call); a serve step's as
    they are."""
    if plan.kind != "train":
        return args
    params, batches, *masks = args
    return (params, {k: v[:, :, :1] for k, v in batches.items()},
            *(m[:, :, :1] for m in masks))


def _budget(spec: DeviceSpec) -> float:
    """The bytes a step may hold: the card's memory less the share kept
    for the CUDA context, workspaces and fragmentation."""
    return spec.hbm_bytes * (1.0 - spec.reserved_fraction)


def _jsonable(overrides: dict | None) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in (overrides or {}).items()}


def _plan_of(rec: dict):
    """The plan a record was counted at (its overrides, lists as tuples)."""
    over = {k: tuple(v) if isinstance(v, list) else v
            for k, v in rec.get("overrides", {}).items()}
    return make_plan(rec["arch"], rec["shape"], overrides=over or None)


def run_cell(arch: str, shape: str, *, run: bool = False,
             overrides: dict | None = None, device=None,
             seed: int = 0, mesh: str = "one") -> dict:
    """Count one cell on meta tensors and return its record; with ``run``
    also measure it on ``device`` (default ``cuda``; see
    :func:`measure_cell`).  ``mesh`` ``"pod"`` or ``"multipod"`` counts the
    cell per card of the reference's production mesh.  A step the counter
    cannot follow (a value read back to the host, a shape made from data)
    gives ``"status": "fail"`` with the op named."""
    if mesh not in MESHES:
        raise ValueError(f"mesh must be one of {MESHES}, got {mesh!r}")
    if mesh != "one":
        if run:
            raise ValueError("--run measures one card; a mesh cell is "
                             "counted only")
        if not runnable(get_arch(arch), shape):
            return skip_record(arch, shape, mesh)
        return _run_mesh_cell(arch, shape, mesh, overrides)
    if run:
        device = _card(device)
    plan = make_plan(arch, shape, overrides=overrides)
    t0 = time.perf_counter()
    fn, args = build_step(plan, "meta")
    try:
        cost = analyze_step(fn, *args)
    except DataDependentOp as e:
        return {"arch": arch, "shape": shape, "status": "fail",
                "op": e.op, "error": str(e),
                "overrides": _jsonable(overrides)}
    count_s = time.perf_counter() - t0
    spec = DeviceSpec()
    hw = HW.from_spec(spec)
    # The step's own sequences: the global batch unless an override cut a
    # serve cell's b (the reference counts the global batch either way).
    seqs = plan.W * plan.P * plan.S * plan.b
    tokens = seqs * (plan.seq_len if plan.kind != "decode" else 1)
    mf = model_flops(plan.cfg, tokens,
                     "train" if plan.kind == "train" else "serve")
    flops = cost.total_flops
    terms = roofline_terms(flops_per_device=cost.flops,
                           bytes_per_device=cost.bytes, hw=hw)
    budget = _budget(spec)
    rec = {
        "arch": arch, "shape": shape, "devices": 1, "kind": plan.kind,
        "policy": plan.policy, "W": plan.W, "P": plan.P, "S": plan.S,
        "b": plan.b, "overrides": _jsonable(overrides),
        "param_bytes": param_bytes(plan.cfg),
        "count_s": count_s, "ops": cost.ops,
        "memory_analysis": {
            "argument_size_in_bytes": cost.argument_bytes,
            "output_size_in_bytes": cost.output_bytes,
            "temp_size_in_bytes": cost.peak_live_bytes - cost.argument_bytes,
            "peak_live_bytes": cost.peak_live_bytes},
        "budget_bytes": budget, "fits": cost.peak_live_bytes <= budget,
        "flops_per_device": flops, "flops_by_dtype": cost.flops,
        "matmul_flops": cost.matmul_flops,
        "bytes_per_device": cost.bytes, "kernels": cost.kernels,
        "model_flops_total": mf, "model_flops_per_device": mf,
        "useful_ratio": mf / flops if flops else 0.0,
        "roofline": terms, "hw": {"name": spec.name,
                                  "peak_flops": hw.peak_flops,
                                  "hbm_bw": hw.hbm_bw},
        "status": "ok",
    }
    if run:
        rec["run"] = measure_cell(rec, device=device, seed=seed)
    return rec


def _run_mesh_cell(arch: str, shape: str, mesh_kind: str,
                   overrides: dict | None) -> dict:
    """:func:`run_cell` per card of a production mesh (meta backend)."""
    mesh = make_production_mesh(multi_pod=mesh_kind == "multipod",
                                backend="meta")
    n_dev = mesh.size
    plan = make_plan(arch, shape, mesh, overrides=overrides)
    t0 = time.perf_counter()
    fn, args = build_step(plan, "meta", mesh=mesh)
    try:
        cost = analyze_step(fn, *args)
    except DataDependentOp as e:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "fail", "op": e.op, "error": str(e),
                "overrides": _jsonable(overrides)}
    count_s = time.perf_counter() - t0
    spec = DeviceSpec()
    hw = HW.from_spec(spec)
    tokens = plan.global_batch * (plan.seq_len if plan.kind != "decode"
                                  else 1)
    mf = model_flops(plan.cfg, tokens,
                     "train" if plan.kind == "train" else "serve")
    flops = cost.total_flops
    terms = roofline_terms(flops_per_device=cost.flops,
                           bytes_per_device=cost.bytes,
                           wire_ici=cost.wire_bytes_ici,
                           wire_dcn=cost.wire_bytes_dcn, hw=hw)
    budget = _budget(spec)
    return {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "devices": n_dev,
        "axes": dict(zip(mesh.axis_names, mesh.shape)), "kind": plan.kind,
        "policy": plan.policy, "W": plan.W, "P": plan.P, "S": plan.S,
        "b": plan.b, "batch_axes": list(plan.batch_axes),
        "moe_dispatch": plan.cfg.moe_dispatch is not None,
        "overrides": _jsonable(overrides),
        "param_bytes": param_bytes(plan.cfg),
        "param_bytes_per_card": param_bytes_per_card(plan, mesh),
        "count_s": count_s, "ops": cost.ops,
        "memory_analysis": {
            "argument_size_in_bytes": cost.argument_bytes,
            "output_size_in_bytes": cost.output_bytes,
            "temp_size_in_bytes": cost.peak_live_bytes - cost.argument_bytes,
            "peak_live_bytes": cost.peak_live_bytes},
        "budget_bytes": budget, "fits": cost.peak_live_bytes <= budget,
        "flops_per_device": flops, "flops_by_dtype": cost.flops,
        "matmul_flops": cost.matmul_flops,
        "bytes_per_device": cost.bytes, "kernels": cost.kernels,
        "collectives": {"count": sum(c["count"] for c in
                                     cost.collectives.values()),
                        "wire_bytes_ici": cost.wire_bytes_ici,
                        "wire_bytes_dcn": cost.wire_bytes_dcn,
                        "by_kind": cost.collectives,
                        "by_kind_axis": cost.collectives_by_axis},
        "model_flops_total": mf, "model_flops_per_device": mf / n_dev,
        "useful_ratio": (mf / n_dev) / flops if flops else 0.0,
        "roofline": terms, "hw": {"name": spec.name,
                                  "peak_flops": hw.peak_flops,
                                  "hbm_bw": hw.hbm_bw,
                                  "link_bw": hw.link_bw,
                                  "dcn_bw": hw.dcn_bw},
        "status": "ok",
    }


def _card(device) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"a dry-run measurement needs the card, got "
                           f"{device}")
    return device


def _finite(out) -> bool:
    from torch.utils._pytree import tree_flatten
    return all(bool(torch.isfinite(t).all()) for t in tree_flatten(out)[0]
               if isinstance(t, torch.Tensor) and t.is_floating_point())


def _kernel_rows(prof) -> list:
    """Device time by kernel, largest first: ``(ms, name, count)``."""
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if us > 0:
                rows.append((us / 1e3, e.key, e.count))
    return sorted(rows, reverse=True)


def measure_cell(rec: dict, *, device=None, seed: int = 0) -> dict:
    """Measure a counted cell (an ``ok`` record of :func:`run_cell`) on the
    card at random weights from ``seed``: a warm-up call (a train cell's
    first local step), the timed call with the launch counts zeroed just
    before and read just after, then a profiled call (again the first
    local step of a train cell) whose aten matrix-product FLOPs are held
    against the counter's for the same call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention, ops, ssd
    dev = _card(device)
    plan = _plan_of(rec)
    hw = HW.from_spec(DeviceSpec())
    fn, args = build_step(plan, dev,
                          params=device_params(plan.cfg, seed, dev),
                          seed=seed)
    warm = first_step(plan, args)
    t0 = time.perf_counter()
    out = fn(*warm)
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    del out
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ops.reset_launch_counts()
    start.record()
    out = fn(*args)
    end.record()
    torch.cuda.synchronize(dev)
    launches = ops.launch_counts()
    routes = {"flash_attention": dict(flash_attention.ROUTE_LAUNCHES),
              "ssd": dict(ssd.ROUTE_LAUNCHES)}
    step_s = start.elapsed_time(end) / 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    finite = _finite(out)
    del out
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True, with_flops=True) as prof:
        out = fn(*warm)
        torch.cuda.synchronize(dev)
    del out
    profiled_mm = sum(e.flops for e in prof.key_averages()
                      if e.key in _PROFILED_MATMULS)
    counted_mm = rec["matmul_flops"]
    if plan.kind == "train":
        meta_fn, meta_args = build_step(plan, "meta")
        counted_mm = analyze_step(meta_fn,
                                  *first_step(plan, meta_args)).matmul_flops
    rows = _kernel_rows(prof)
    busy = sum(r[0] for r in rows)
    kernels = {}
    for name, match in (("fedavg_accum", "fedavg"),
                        ("flash_attention", "flash_attention"),
                        ("ssd", "ssd_fwd")):
        ms = sum(r[0] for r in rows if match in r[1])
        n = sum(r[2] for r in rows if match in r[1])
        if n:
            kernels[name] = {"profiled_ms": ms, "profiled_launches": n}
    del fn, args, warm
    torch.cuda.empty_cache()
    terms = rec["roofline"]
    return {
        "device": torch.cuda.get_device_name(dev), "seed": seed,
        "warmup_s": warm_s, "step_s": step_s, "launches": launches,
        "routes": routes,
        "finite": finite, "peak_bytes": peak,
        "predicted_peak_bytes": rec["memory_analysis"]["peak_live_bytes"],
        "profiled_call": "first local step" if plan.kind == "train"
        else "the step",
        "profiled_busy_ms": busy, "profiled_kernels": kernels,
        "top_kernels": [{"name": k[:80], "ms": ms, "count": n}
                        for ms, k, n in rows[:10]],
        "matmul_flops_profiled": profiled_mm,
        "matmul_flops_counted": counted_mm,
        "matmul_flops_rel_diff": (abs(counted_mm - profiled_mm)
                                  / profiled_mm if profiled_mm else math.inf),
        "mfu": rec["model_flops_total"] / step_s / hw.peak("bfloat16"),
        "roofline_fraction": terms["step_lower_bound_s"] / step_s,
    }


def parse_overrides(items) -> dict:
    """``--set k=v`` items as the reference parses them: int where it
    parses, a tuple for a comma list, ``()`` for an empty value."""
    overrides = {}
    for kv in items:
        k, v = kv.split("=", 1)
        if "," in v:
            overrides[k] = tuple(x for x in v.split(",") if x)
        elif v == "":
            overrides[k] = ()
        else:
            try:
                overrides[k] = int(v)
            except ValueError:
                overrides[k] = v
    return overrides


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--set", action="append", default=[],
                    help="hillclimb override key=value (int/str/tuple), "
                         "e.g. --set S=32 --set b=8")
    ap.add_argument("--tag", default="",
                    help="suffix for the output json (variant runs)")
    ap.add_argument("--run", action="store_true",
                    help="also run each cell on the card")
    ap.add_argument("--mesh", choices=MESHES, default="one",
                    help="one card (default), or count each cell per card "
                         "of the reference's 16x16 (pod) or 2x16x16 "
                         "(multipod) mesh")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.set)
    archs = [args.arch] if args.arch else ARCH_NAMES
    shapes = [args.shape] if args.shape else list(SHAPES)
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            tag = f"{arch:24s} {shape:12s}"
            suffix = f"__{args.tag}" if args.tag else ""
            if args.mesh != "one":
                suffix = f"__{args.mesh}{suffix}"
            path = os.path.join(args.out, f"{arch}__{shape}{suffix}.json")
            if not runnable(get_arch(arch), shape):
                rec = skip_record(arch, shape, args.mesh)
                print(f"SKIP {tag} ({rec['reason'][:60]}...)")
            else:
                try:
                    rec = run_cell(arch, shape, run=args.run,
                                   overrides=overrides or None,
                                   mesh=args.mesh)
                except Exception as e:  # noqa: BLE001 — record, go on
                    rec = {"arch": arch, "shape": shape, "status": "fail",
                           "error": repr(e), "overrides": _jsonable(overrides),
                           "traceback": traceback.format_exc()[-4000:]}
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    line = (f"OK   {tag} count={rec['count_s']:6.1f}s "
                            f"fits={rec['fits']!s:5s} "
                            f"GFLOP={rec['flops_per_device'] / 1e9:.4g} "
                            f"GB={rec['bytes_per_device'] / 1e9:.4g} "
                            f"dom={r['dominant']:10s} "
                            f"useful={rec['useful_ratio']:.3f}")
                    if "run" in rec:
                        m = rec["run"]
                        line += (f" step={m['step_s']:.4g}s "
                                 f"mfu={m['mfu']:.3f} "
                                 f"frac={m['roofline_fraction']:.3f}")
                    print(line, flush=True)
                else:
                    failures += 1
                    print(f"FAIL {tag} {rec.get('op') or rec['error']}",
                          flush=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    print(f"done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
