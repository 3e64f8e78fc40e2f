"""The yardstick's arithmetic: the card's published peaks, the bytes each
hand-written kernel must move, and the model FLOPs of a training step.

Frozen here, apart from the program, so that a later change to the
program cannot move what it is measured against.  The kernel count starts
from ``repro_torch/kernels/work.py``; the peaks are NVIDIA's H100 SXM
data sheet (dense, without sparsity), for a card at its full 700 W.
"""

from __future__ import annotations

__all__ = ["PEAK_FLOPS", "HBM_BYTES_PER_S", "DTYPE_BYTES",
           "fedavg_accum_bytes", "sr_step_flops", "qwen3_step_flops",
           "step_flops"]

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


def fedavg_accum_bytes(lanes: int, n: int, dtype: str) -> int:
    """The least bytes K1 moves on an ``[lanes, n]`` pair: every lane's
    ``acc`` read once and its result written once.  ``theta`` is read only
    where a lane folds; a lane whose weights are both 0 (no client folded
    yet) passes ``acc`` through, and at 128 lanes K1 ran faster than a read
    of every ``theta`` allows, so the count leaves ``theta`` out: which
    lanes fold depends on the placement, which the trace does not give."""
    return 2 * lanes * n * DTYPE_BYTES[dtype]


def sr_step_flops(cfg: dict, examples: int) -> float:
    """Forward and backward of the SR model over ``examples`` rows:
    ``6 × (matrix parameters) × rows`` (each weight one multiply-add in
    forward, two in backward)."""
    d, w, k = cfg["input_dim"], cfg["width"], cfg["n_classes"]
    params = d * w + 2 * cfg["n_blocks"] * w * w + w * k
    return 6.0 * params * examples


def qwen3_step_flops(cfg: dict, batch: int, seq_len: int) -> float:
    """Forward and backward of a Qwen3 batch of ``batch`` sequences of
    ``seq_len`` tokens: ``6 × (matrix parameters of the layers) ×
    tokens``, the head's ``6 × D × V`` for the ``seq_len - 1`` predicted
    positions, and causal attention's ``QK^T`` and ``PV``: per sequence,
    head and key/query pair below the diagonal 2 × 2 × head_dim in forward,
    twice that in backward."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, F, V = cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"]
    layer = D * H * hd + 2 * D * Hkv * hd + H * hd * D + 3 * D * F
    tokens = batch * seq_len
    dense = 6.0 * L * layer * tokens
    head = 6.0 * D * V * batch * (seq_len - 1)
    pairs = seq_len * (seq_len + 1) // 2
    attn = 3.0 * 4.0 * L * H * hd * pairs * batch
    return dense + head + attn


def step_flops(cfg: dict, rows: int) -> float:
    """The model FLOPs of one client step of the configuration ``cfg``
    (its ``model`` key names the formula)."""
    if cfg["model"] == "sr":
        return sr_step_flops(cfg, rows)
    if cfg["model"] == "qwen3":
        return qwen3_step_flops(cfg, rows, cfg["assumed"]["seq_len"])
    raise ValueError(f"no FLOP count for model {cfg['model']!r}")
