"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one run of one
cell, from the seed to the result line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``perfbench/configs/<name>.json``: the model's sizes, its data and its
client optimizer) and a traffic mix (``perfbench/traffic/<name>.json``:
cohort, workers, lanes, steps cap, clip, pipeline depth, warm-up rounds).
A run:

1. builds the engine as ``repro_torch.launch.train.main`` does
   (``set_deterministic``, then ``build_engine``) on the configuration's
   dataset, reseeds its cohort sampler with ``--seed``, and hands it
   weights drawn on the card from ``--seed`` (:mod:`perfbench.weights`);
2. drives it through its first rounds with ``FederatedEngine.run`` — the
   window's own call — keeping the model after round 1 and after the last
   of them for the check;
3. times the window: one ``FederatedEngine.run(n)``, the pipelined loop
   users run, ``n`` from the warm-up's round time so that it lasts about
   ``--seconds``; with ``--trace 1`` the engine's spans are on and the
   whole window runs under ``torch.profiler``;
4. frees the program's state, trains the same first rounds with the plain
   reference (:mod:`perfbench.reference`) from the same weights on the
   same traffic, and compares (:mod:`perfbench.reference.compare`) against
   the cell's limits (``perfbench/limits/<cell>.json``);
5. reads the metrics, each by its own reader
   ``perfbench/metrics/<name>.py``: the end-to-end ones in an untraced
   run, the per-layer ones in a traced run.

The harness imports nothing of the JAX package: :func:`forbidden_modules`
is checked after the window, in the process that prints the result.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from perfbench.weights import make_weights

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["parts", "load_cell", "warm_up", "run_cell", "forbidden_modules",
           "Run", "Trace", "read_metrics", "breakdown", "main"]


# ---------------------------------------------------------------------------
# the cell, found by name
# ---------------------------------------------------------------------------
def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def parts(config: str, traffic: str, root: Path = ROOT) -> dict:
    """A configuration and a traffic mix, each read from its own file: the
    configuration's as ``BENCHMARK.json`` names it, or
    ``perfbench/configs/<config>.json`` for one that no cell uses yet."""
    conf = next((c for c in manifest(root)["configs"]
                 if c["name"] == config), None)
    path = root / (conf["file"] if conf else
                   f"perfbench/configs/{config}.json")
    return {"config": json.loads(path.read_text()),
            "traffic": json.loads((root / "perfbench" / "traffic" /
                                   f"{traffic}.json").read_text())}


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The workload ``name`` with its configuration, traffic and limits,
    each read from its own file."""
    man = manifest(root)
    wl = next((w for w in man["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return {"workload": wl, **parts(wl["config"], wl["traffic"], root),
            "limits": json.loads((root / "perfbench" / "limits" /
                                  f"{name}.json").read_text()),
            "end_to_end": [m for m in man["end_to_end"]
                           if name in m.get("workloads", [name])],
            "per_layer": [m for m in man["per_layer"]
                          if name in m.get("workloads", [name])]}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (``repro``; ``repro_torch`` is another name)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------
_ARCH_KEYS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
              "num_hidden_layers": "n_layers",
              "num_attention_heads": "n_heads",
              "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
              "vocab_size": "vocab_size", "rope_theta": "rope_theta",
              "rms_norm_eps": "norm_eps",
              "tie_word_embeddings": "tie_embeddings",
              "torch_dtype": "dtype"}


def build(cfg: dict, traffic: dict, seed: int, device, obs=None):
    """The engine of a cell, composed by ``build_engine`` as the CLI does,
    on the configuration's dataset (``data.seed``: every run trains the
    same clients) with its cohorts drawn from the run's ``seed``."""
    from repro_torch.launch.train import build_engine, set_deterministic
    set_deterministic()
    prog = cfg["program"]
    kw = dict(placement=traffic["placement"], cohort=traffic["cohort"],
              workers=traffic["workers"],
              concurrency=traffic["lanes_per_worker"],
              strategy=traffic["strategy"], steps_cap=traffic["steps_cap"],
              grad_clip=traffic.get("grad_clip"),
              pipeline_depth=traffic["pipeline_depth"],
              sampler=traffic["sampler"], seed=int(cfg["data"]["seed"]),
              obs=obs, device=device, **traffic.get("engine", {}))
    if traffic["sampler"] == "zipf":
        kw["zipf_exponent"] = traffic["zipf_exponent"]
    if "task" in prog:
        engine = build_engine(task=prog["task"], **kw)
    else:
        from dataclasses import replace

        from repro_torch.configs import get_arch
        lm_cfg = replace(get_arch(prog["arch"]),
                         **{v: cfg[k] for k, v in _ARCH_KEYS.items()})
        engine = build_engine(lm_cfg=lm_cfg, preset=prog["preset"], **kw)
    engine.sampler.rng = np.random.default_rng(int(seed))
    return engine


def program_paths(engine) -> dict:
    """``{reference leaf name: the program's flat path}``: a path's last
    key names the leaf."""
    from repro_torch.kernels.layout import flatten_tree
    out = {}
    for path in flatten_tree(engine.params):
        name = path.split("/")[-1]
        if name in out:
            raise ValueError(f"two program leaves end in {name!r}")
        out[name] = path
    return out


def program_theta(engine, paths: dict, like: dict) -> dict:
    """The engine's global model on the host, by reference leaf name, each
    leaf cut to the reference's shape ``like[name]`` (the program pads the
    vocabulary's rows to a multiple of 256)."""
    from repro_torch.kernels.layout import flatten_tree
    flat = flatten_tree(engine.params)
    return {k: flat[p][tuple(slice(0, n) for n in like[k].shape)]
            .detach().to("cpu", copy=True) for k, p in paths.items()}


def hand_weights(engine, theta0: dict) -> dict:
    """Give the engine the benchmark's weights ``theta0`` (by reference
    leaf name) and return ``{name: program path}``.  A program leaf may be
    longer than the reference's in its first dim only (the vocabulary
    padded to a multiple of 256): the extra rows are zeros, which the
    program's loss masks out."""
    from repro_torch.kernels.layout import flatten_tree
    paths = program_paths(engine)
    if set(paths) != set(theta0):
        raise ValueError(f"program leaves {sorted(paths)} are not the "
                         f"configuration's {sorted(theta0)}")
    flat = flatten_tree(engine.params)
    given = {}
    for k, p in paths.items():
        have, want = flat[p], theta0[k]
        pad = have.shape[0] - want.shape[0] if have.ndim else 0
        if (have.dtype != want.dtype or have.ndim != want.ndim or pad < 0
                or tuple(have.shape[1:]) != tuple(want.shape[1:])):
            raise ValueError(f"{k}: program {tuple(have.shape)} {have.dtype}"
                             f", configuration {tuple(want.shape)} "
                             f"{want.dtype}")
        if pad:
            want = torch.cat([want, want.new_zeros((pad,) + want.shape[1:])])
        given[p] = want
    engine.params = given
    return paths


def real_steps(r, lanes: int) -> int:
    """A round's unpadded client steps: every lane's ``S`` slots less the
    masked ones."""
    return lanes * r.s_steps - r.padded_steps


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------
_MARK = "spin_kernel"          # torch.cuda._sleep's kernel: the clock mark


def _device_events(prof) -> list:
    """``(name, start_s, dur_s)`` of every device activity (kernels,
    copies, fills) in a profile, on the profiler's clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        out.append((e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9))
    out.sort(key=lambda x: x[1])
    return out


def _union(events, lo: float, hi: float) -> list:
    """Merged busy intervals of ``events`` clipped to ``[lo, hi]``."""
    spans = []
    for _, s, d in events:
        a, b = max(s, lo), min(s + d, hi)
        if b <= a:
            continue
        if spans and a <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], b)
        else:
            spans.append([a, b])
    return spans


@dataclass
class Trace:
    """The traced window: device activity, on the host's clock."""

    kernels: list            # (name, start_s, dur_s), host clock
    t0: float                # window start, host clock
    t1: float                # window end
    busy: list               # merged busy intervals inside [t0, t1]
    rounds: list             # the RoundResults of the window

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)


def profile_rounds(engine, n: int):
    """Run ``engine.run(n)`` under ``torch.profiler`` (device activity
    only) and return ``(results, Trace)``.  A ``torch.cuda._sleep`` kernel
    launched at a known host time ties the profiler's clock to the host's."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run(n)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    events = _device_events(prof)
    mark = next(e for e in events if _MARK in e[0])
    offset = mark[1] - t_mark           # device clock - host clock
    kernels = [(nm, s - offset, d) for nm, s, d in events
               if _MARK not in nm]
    return results, Trace(kernels=kernels, t0=t0, t1=t1,
                          busy=_union(kernels, t0, t1), rounds=results)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------
@dataclass
class Run:
    """What a run hands the metric readers."""

    cell: dict
    lanes: int
    window: list                      # RoundResults of the window
    window_s: float
    setup_s: float
    peak_bytes: int
    group_elems: dict                 # {dtype name: elements of θ}
    trace: Trace | None = None
    spans: list = field(default_factory=list)
    power_limit: str = ""


def reference_readings(cfg: dict, traffic: dict, seed: int, theta0: dict,
                       device, rounds: int, q=None, half_batch: bool = False,
                       stack: int | None = None) -> dict:
    """The plain reference's first ``rounds`` rounds from ``theta0``, in
    full float32 products, or with a control's precision (``q``) or a
    planted fault, as the check reads them; ``stack`` clients side by side
    (the model's ``STACK`` by default)."""
    from perfbench.reference import fl
    from perfbench.reference.data import Traffic
    model = importlib.import_module(f"perfbench.reference.{cfg['model']}")
    opt = dict(cfg["optimizer"], grad_clip=traffic.get("grad_clip"))
    with _f32():
        out = fl.run_rounds(lambda p, b, qq: model.loss(p, b, cfg, qq),
                            {k: v.to(device) for k, v in theta0.items()},
                            Traffic(seed, cfg["data"]), rounds=rounds,
                            mix=traffic, opt=opt,
                            steps_cap=traffic["steps_cap"], device=device,
                            q=q, half_batch=half_batch,
                            stack=stack or model.STACK)
    return {"losses": out["losses"], "theta1": out["thetas"][0],
            "thetaR": out["thetas"][-1]}


@contextlib.contextmanager
def _f32():
    """Full float32 products (no TF32) for the reference's own run."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def warm_up(cell: dict, seed: int, device, obs=None):
    """Set-up's part of a run that the check reads: build the cell's
    engine, hand it the weights drawn from ``seed``, and drive it through
    its ``warmup_rounds`` first rounds with ``FederatedEngine.run``, the
    window's own call.  Returns ``(engine, theta0 on the host, the rounds'
    results, {"losses", "theta1", "thetaR"})``: the model after round 1
    and after the last."""
    cfg, traffic = cell["config"], cell["traffic"]
    engine = build(cfg, traffic, seed, device, obs=obs)
    theta0 = make_weights(cfg, seed, device)
    paths = hand_weights(engine, theta0)
    theta0 = {k: v.to("cpu", copy=True) for k, v in theta0.items()}
    warm = engine.run(1)
    theta1 = program_theta(engine, paths, theta0)
    warm += engine.run(int(traffic["warmup_rounds"]) - 1)
    prog = {"losses": [r.loss for r in warm], "theta1": theta1,
            "thetaR": program_theta(engine, paths, theta0)}
    return engine, theta0, warm, prog


def run_cell(cell: dict, *, seed: int, seconds: float, trace: bool,
             device="cuda", t_process: float | None = None
             ) -> tuple[Run, dict]:
    """One run of ``cell`` (from :func:`load_cell`) on ``device``; the
    command runs it on the card, the tests on the CPU.  Returns the run's
    records and the check ``{number: (value, limit)}``."""
    t_start = time.perf_counter() if t_process is None else t_process
    cfg, traffic = cell["config"], cell["traffic"]
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    obs = None
    if trace:
        from repro_torch.obs import make_observability
        obs = make_observability(trace_rounds=8192)
    engine, theta0, warm, prog = warm_up(cell, seed, device, obs)
    lanes = traffic["workers"] * traffic["lanes_per_worker"]
    # A round's time once the pipeline runs: the first round of each
    # ``run`` call waits for its own packing, so warm[0] and warm[1] do.
    est = statistics.fmean(r.wall_time for r in warm[2:] or warm[-1:])
    n = max(2, math.ceil(seconds / max(est, 1e-3)))
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    tw0 = time.perf_counter()
    tr = None
    if trace and cuda:
        window, tr = profile_rounds(engine, n)
    else:
        window = engine.run(n)
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - tw0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    spans = obs.tracer.snapshot() if obs is not None else []
    group_elems: dict = {}
    for k, v in theta0.items():
        name = str(v.dtype).replace("torch.", "")
        group_elems[name] = group_elems.get(name, 0) + v.numel()
    run = Run(cell=cell, lanes=lanes, window=window, window_s=window_s,
              setup_s=setup_s, peak_bytes=peak, group_elems=group_elems,
              trace=tr, spans=spans, power_limit=_power_limit() if cuda
              else "")
    del engine, warm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from perfbench.reference.compare import numbers
    ref = reference_readings(cfg, traffic, seed, theta0, device,
                             len(prog["losses"]))
    got = numbers(theta0, prog, ref)
    check = {k: (got[k], float(cell["limits"][k])) for k in got}
    return run, check


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def read_metrics(run: Run, metrics: list) -> dict:
    """Each metric (entries of ``BENCHMARK.json``) by its own reader,
    ``perfbench/metrics/<name>.py``; a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    for m in metrics:
        reader = importlib.import_module(f"perfbench.metrics.{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(run: Run) -> dict:
    """The trace's top device operations, and its idle gaps summed by the
    engine span the host was in (``MainThread`` first, then the producer)."""
    tr = run.trace
    by_op: dict = {}
    for name, s, d in tr.kernels:
        if s + d <= tr.t0 or s >= tr.t1:
            continue
        by_op[name] = by_op.get(name, 0.0) + d
    edges = [tr.t0] + [x for iv in tr.busy for x in iv] + [tr.t1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    mid = np.array([(a + b) / 2 for a, b in gaps])
    # The engine span each gap's middle lies in: the main thread's before
    # the producer's, then the innermost.
    best = np.full((len(gaps), 2), np.inf)
    label = np.full(len(gaps), "host (no engine span)", dtype=object)
    for r in run.spans:
        if r[0] != "X":
            continue
        name, a, b = r[1], r[2], r[2] + r[3]
        key = (0 if r[4] == "MainThread" else 1, b - a)
        lo = np.searchsorted(mid, a, side="left")
        hi = np.searchsorted(mid, b, side="right")
        if hi <= lo:
            continue
        sl = slice(lo, hi)
        better = (key[0] < best[sl, 0]) | ((key[0] == best[sl, 0]) &
                                           (key[1] < best[sl, 1]))
        idx = np.arange(lo, hi)[better]
        best[idx] = key
        label[idx] = name
    idle: dict = {}
    for (a, b), name in zip(gaps, label):
        idle[name] = idle.get(name, 0.0) + (b - a)
    top = sorted(by_op.items(), key=lambda x: -x[1])[:10]
    idle = sorted(idle.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------
def main(argv=None, t_process: float | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run, check = run_cell(cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), t_process=t_process)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    correct = all(math.isfinite(v) and v <= lim for v, lim in check.values())
    metrics = read_metrics(run, cell["per_layer" if args.trace
                                    else "end_to_end"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(run.peak_bytes)}
    line = {"correct": correct, "attempted": len(run.window),
            "failed": sum(1 for r in run.window if not math.isfinite(r.loss)),
            "metrics": metrics, "device": device,
            "card": run.power_limit}
    if args.trace:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = breakdown(run)
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in check.items()}
    for k, (v, lim) in check.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0
