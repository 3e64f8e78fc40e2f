"""Concurrency estimation (paper §3.2) — port of
``repro/core/concurrency.py`` for the CUDA card.

The paper probes one client on a GPU, reads VRAM allocation + utilization
from ``nvidia-smi``, and derives how many concurrent worker processes the
GPU sustains (Table 3: e.g. 33 on an A40 for TG, 3 on a 2080 Ti for MLM).

The simulator has no processes: "concurrency" is **client slots per
worker** — how many client-model copies (params + optimizer state +
working set) fit in the card's memory next to the global copy and the
round's activations.  The estimators are the reference's, verbatim:

* :func:`estimate_slots_analytic` — closed-form from parameter/activation
  byte counts.
* :func:`estimate_slots_from_memory_analysis` — refined from a measured
  round's argument/output/temp bytes, duck-typed as XLA's
  ``compiled.memory_analysis()`` is.  On the card those bytes come from
  :func:`round_memory_analysis`, which runs one lane-loop round at
  ``slots_compiled`` lanes and reads the allocator's peak (the paper's
  probe-one-client-then-read-the-card step).
* :func:`gpu_concurrency_probe` — the paper's VRAM rule.

:class:`DeviceSpec` keeps the reference's field names; its defaults
describe an H100 SXM (80 GB), and :meth:`DeviceSpec.from_card` reads the
name and memory of the card in use.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "DeviceSpec",
    "ConcurrencyEstimate",
    "RoundMemoryAnalysis",
    "estimate_slots_analytic",
    "estimate_slots_from_memory_analysis",
    "gpu_concurrency_probe",
    "round_memory_analysis",
]


@dataclass(frozen=True)
class DeviceSpec:
    """Per-card hardware description (defaults: NVIDIA H100 SXM, 80 GB).

    ``peak_flops`` is the dense bf16 tensor-core peak and ``hbm_bw`` the
    memory rate, both from NVIDIA's data sheet.  ``ici_bw`` and
    ``vmem_bytes`` keep the reference's field names but have no meaning
    on one card (no inter-chip links in the estimate, no software-managed
    vector memory) and are 0.  ``reserved_fraction`` is the share of
    memory kept back for the CUDA context, cuBLAS workspaces and the
    allocator's fragmentation."""

    name: str = "NVIDIA H100 80GB HBM3"
    hbm_bytes: int = 80 * 10 ** 9
    peak_flops: float = 989e12          # bf16, dense
    hbm_bw: float = 3.35e12             # bytes/s
    ici_bw: float = 0.0                 # no H100 meaning
    vmem_bytes: int = 0                 # no H100 meaning
    reserved_fraction: float = 0.08     # runtime/framework reservation

    @classmethod
    def from_card(cls, device=None) -> "DeviceSpec":
        """The spec of a CUDA card: its name and total memory from
        ``torch.cuda.get_device_properties``, the rates the defaults'."""
        import torch
        props = torch.cuda.get_device_properties(
            torch.device("cuda") if device is None else device)
        return cls(name=props.name, hbm_bytes=int(props.total_memory))


@dataclass(frozen=True)
class ConcurrencyEstimate:
    slots: int
    bytes_per_slot: int
    fixed_bytes: int          # global params + activations, slot-independent
    budget_bytes: int
    detail: str = ""

    def __str__(self):
        return (f"slots={self.slots} slot={self.bytes_per_slot/2**30:.2f}GiB "
                f"fixed={self.fixed_bytes/2**30:.2f}GiB "
                f"budget={self.budget_bytes/2**30:.2f}GiB {self.detail}")


def estimate_slots_analytic(
    *,
    param_bytes: int,
    optimizer_bytes_per_param_byte: float,
    activation_bytes: int,
    group_devices: int,
    device: DeviceSpec = DeviceSpec(),
    max_slots: int = 64,
) -> ConcurrencyEstimate:
    """Closed-form slot estimate for one worker group.

    A slot needs one trainable client copy: params + optimizer state + the
    gradient working set (~1 param copy, reused).  The global model copy and
    the per-step activation working set are shared across slots because slots
    execute sequentially inside a ``lax.scan`` (only their *parameters*
    persist; activations are reused).  Memory is pooled over ``group_devices``
    since all client state is sharded over the worker group's chips.
    """
    budget = int(device.hbm_bytes * (1.0 - device.reserved_fraction)) * group_devices
    fixed = param_bytes + activation_bytes          # global copy + working set
    per_slot = int(param_bytes * (1.0 + optimizer_bytes_per_param_byte + 1.0))
    free = budget - fixed
    slots = max(0, min(max_slots, free // max(per_slot, 1)))
    return ConcurrencyEstimate(
        slots=int(slots), bytes_per_slot=per_slot, fixed_bytes=fixed,
        budget_bytes=budget,
        detail=f"analytic group_devices={group_devices}")


def estimate_slots_from_memory_analysis(
    mem_analysis, *, slots_compiled: int, group_devices: int,
    device: DeviceSpec = DeviceSpec(), max_slots: int = 64,
) -> ConcurrencyEstimate:
    """Refine the analytic estimate from a measured round step.

    ``mem_analysis`` is :func:`round_memory_analysis`'s result (or XLA's
    ``compiled.memory_analysis()``, which has the same fields); we read per-device
    argument/output/temp sizes, attribute the temp+arg growth to the compiled
    slot count, and extrapolate the max slot count that stays in budget.
    Mirrors the paper's probe-then-extrapolate concurrency estimator.
    """
    try:
        arg = int(mem_analysis.argument_size_in_bytes)
        out = int(mem_analysis.output_size_in_bytes)
        tmp = int(mem_analysis.temp_size_in_bytes)
    except AttributeError:  # backend without full analysis: stay conservative
        return ConcurrencyEstimate(slots=slots_compiled, bytes_per_slot=0,
                                   fixed_bytes=0, budget_bytes=0,
                                   detail="memory_analysis unavailable")
    budget = int(device.hbm_bytes * (1.0 - device.reserved_fraction))
    used = arg + out + tmp
    # Slots scale the client-param planes of args/temps ~linearly; treat the
    # whole used set conservatively as slot-linear beyond a fixed floor of the
    # argument size (global params + batches are fixed inputs).
    fixed = arg
    per_slot = max(1, (used - fixed) // max(slots_compiled, 1))
    free = budget - fixed
    slots = max(1, min(max_slots, free // per_slot))
    return ConcurrencyEstimate(
        slots=int(slots), bytes_per_slot=int(per_slot), fixed_bytes=int(fixed),
        budget_bytes=budget,
        detail=f"from memory_analysis; compiled_slots={slots_compiled} "
               f"group_devices={group_devices}")


def gpu_concurrency_probe(vram_bytes: int, client_vram_bytes: int,
                          util_per_client: float, *, max_procs: int = 64) -> int:
    """The paper's original GPU rule, kept for the cluster simulator: probe
    one client, then fit as many processes as VRAM (and compute utilization)
    allow.  Reproduces Table 3 given the simulator's task profiles."""
    by_mem = vram_bytes // max(client_vram_bytes, 1)
    by_util = int(1.0 / max(util_per_client, 1e-6))
    return int(max(1, min(max_procs, by_mem, max(by_util, 1))))


@dataclass(frozen=True)
class RoundMemoryAnalysis:
    """Bytes of one lane-loop round on the card, under the field names of
    XLA's ``memory_analysis()``:

    * ``argument_size_in_bytes`` — the round's inputs on the device: the
      global params plus the round's batches, step mask, boundary and
      weight arrays;
    * ``output_size_in_bytes`` — what the round returns: the new global
      params and its metrics;
    * ``temp_size_in_bytes`` — the allocator's peak during the round above
      the inputs already resident, less the outputs: lane params,
      optimizer state, activations, gradients and partials.
    """

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    peak_bytes: int          # max_memory_allocated over the round
    slots_compiled: int
    s_steps: int


def _nbytes(x) -> int:
    import torch
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if hasattr(x, "flat"):                  # a FlatTree
        return _nbytes(x.flat)
    if hasattr(x, "__dataclass_fields__"):  # the round's metrics
        return sum(_nbytes(getattr(x, f)) for f in x.__dataclass_fields__)
    return 0


def round_memory_analysis(engine, *, slots_compiled: int
                          ) -> RoundMemoryAnalysis:
    """Run ONE lane-loop round of ``engine``'s fused round step at
    ``slots_compiled`` lanes on the card and measure its bytes (the
    counterpart of XLA's ``compiled.memory_analysis()``).

    The round is one worker with ``slots_compiled`` lanes, each lane a
    client (ids ``0 .. slots_compiled - 1`` of the engine's dataset),
    packed as the engine packs (``steps_cap``, S-bucketing).  The inputs
    are copied to the card first; then ``torch.cuda.reset_peak_memory_stats``
    and the round, synced, and ``max_memory_allocated`` gives the peak.
    The engine's own state (params, history, RNGs) is left untouched.
    Raises on an engine that is not on a CUDA card: the CPU has no
    allocator statistics to read, and a guess would not be a
    measurement."""
    import torch

    from repro_torch.core.placement import (Assignment, ClientInfo,
                                            WorkerInfo)
    from repro_torch.data.batching import build_round_arrays, plan_round
    from repro_torch.fl.round import make_round_step

    dev = engine.device
    if dev.type != "cuda":
        raise RuntimeError(
            f"round_memory_analysis measures the CUDA allocator; the engine "
            f"is on {dev}")
    if slots_compiled < 1:
        raise ValueError(f"slots_compiled must be >= 1, got {slots_compiled}")
    if engine._round_step is None:
        raise ValueError("round_memory_analysis runs the fused round step; "
                         "the engine's strategy takes the gather path")
    cfg = engine.cfg
    ds = engine.dataset
    clients = [ClientInfo(cid=c, n_batches=ds.n_batches(c),
                          n_samples=ds.n_samples(c))
               for c in range(slots_compiled)]
    worker = WorkerInfo(wid=0, type_name="probe", concurrency=slots_compiled)
    assignment = Assignment(per_worker={0: clients})
    plan = plan_round(assignment, [worker], lanes_per_worker=slots_compiled,
                      steps_cap=cfg.steps_cap, min_steps=1)
    arrays = build_round_arrays(ds, plan=plan, batch_size=cfg.batch_size,
                                seq_len=cfg.seq_len, s_align=engine._s_align)

    def put(a):
        return torch.from_numpy(a).to(dev)

    inputs = ({k: put(v) for k, v in arrays.batches.items()},
              put(arrays.step_mask), put(arrays.boundary),
              put(arrays.weight))
    step = make_round_step(engine.loss_fn, engine.optimizer,
                           agg_impl=cfg.agg_impl, grad_clip=cfg.grad_clip)
    params = engine._params
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    new_params, metrics = step(params, *inputs)
    float(metrics.loss)                          # the round's sync point
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    arg = _nbytes(params) + _nbytes(inputs)
    out = _nbytes(new_params) + _nbytes(metrics)
    tmp = max(peak - base - out, 0)
    del new_params, metrics
    return RoundMemoryAnalysis(
        argument_size_in_bytes=int(arg), output_size_in_bytes=int(out),
        temp_size_in_bytes=int(tmp), peak_bytes=int(peak),
        slots_compiled=int(slots_compiled),
        s_steps=int(arrays.step_mask.shape[-1]))
