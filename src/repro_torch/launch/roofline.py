"""Roofline terms of a counted step on one card — port of
``repro/launch/roofline.py``.

Three terms per (arch × shape × mesh) cell, in seconds:

    compute    = Σ_dtype counted FLOPs of that dtype / the card's peak for it
    memory     = counted bytes / the card's memory rate
    collective = wire bytes inside a pod / the NVLink rate
                 + wire bytes over the pod axis / the InfiniBand rate

The counts come from :mod:`repro_torch.launch.op_cost`, per card; the wire
bytes are the collectives a meta mesh records there, at the reference's
ring formulas (an all-gather ``(g-1)/g`` of its result, an all-reduce
``2 (g-1)/g``), 0 on one card.  The rates come from
:class:`~repro_torch.core.concurrency.DeviceSpec` (an H100 SXM: 989 TFLOP/s
dense bf16, 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s; NVLink 450
GB/s and InfiniBand 50 GB/s each way, NVIDIA's published figures).

MODEL_FLOPS = 6·N_active·tokens (train) or 2·N_active·tokens (serve); the
ratio MODEL_FLOPS / counted FLOPs exposes remat, padding and dispatch
waste.  The reference parses its collectives from a compiled HLO program
(``parse_collectives``, ``collective_summary``); the port records them as
they run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.concurrency import DeviceSpec

__all__ = ["HW", "roofline_terms", "model_flops"]


@dataclass(frozen=True)
class HW:
    """The card's rates: ``peak_flops`` by dtype name (bf16 and f16 on the
    tensor cores; every other dtype at ``peak_flops["float32"]``), the
    memory rate and size."""

    peak_flops: dict = field(default_factory=lambda: HW.from_spec(
        DeviceSpec()).peak_flops)
    hbm_bw: float = DeviceSpec.hbm_bw
    hbm_bytes: int = DeviceSpec.hbm_bytes
    link_bw: float = DeviceSpec.nvlink_bw       # inside a pod, each way
    dcn_bw: float = DeviceSpec.ib_bw            # over the pod axis

    @classmethod
    def from_spec(cls, spec: DeviceSpec) -> "HW":
        return cls(peak_flops={"bfloat16": spec.peak_flops,
                               "float16": spec.peak_flops,
                               "float32": spec.peak_flops_f32},
                   hbm_bw=spec.hbm_bw, hbm_bytes=spec.hbm_bytes,
                   link_bw=spec.nvlink_bw, dcn_bw=spec.ib_bw)

    def peak(self, dtype: str) -> float:
        """The peak rate for FLOPs of ``dtype`` (its name)."""
        if dtype in self.peak_flops:
            return self.peak_flops[dtype]
        return self.peak_flops["float32"]


def model_flops(cfg, tokens: int, kind: str) -> float:
    """6·N_active·T (train) / 2·N_active·T (serve); MoE experts scaled by
    top_k/E; embeddings excluded (standard MFU convention).  ``N`` from
    :func:`~repro_torch.models.lm.param_shapes`."""
    from repro_torch.launch.plan import param_leaves
    n_active = 0.0
    for name, shape, _ in param_leaves(cfg):
        size = float(math.prod(shape))
        if name.endswith(("embed", "lm_head", "pos_embed")):
            continue
        if "moe_" in name.rsplit("/", 1)[-1]:
            size *= cfg.top_k / max(cfg.n_experts, 1)
        n_active += size
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens


def roofline_terms(*, flops_per_device, bytes_per_device: float,
                   wire_ici: float = 0.0, wire_dcn: float = 0.0,
                   hw: HW = HW()) -> dict:
    """The terms of one step: ``flops_per_device`` is ``{dtype name:
    FLOPs}`` (a bare number counts at the bf16 peak); ``wire_ici`` and
    ``wire_dcn`` the wire bytes each card sends inside its pod and over the
    pod axis."""
    flops = flops_per_device if isinstance(flops_per_device, dict) \
        else {"bfloat16": flops_per_device}
    compute = sum(f / hw.peak(d) for d, f in flops.items())
    memory = bytes_per_device / hw.hbm_bw
    collective = wire_ici / hw.link_bw + wire_dcn / hw.dcn_bw
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dom
    terms["step_lower_bound_s"] = bound
    terms["roofline_fraction"] = (compute / bound) if bound > 0 else 0.0
    return terms
