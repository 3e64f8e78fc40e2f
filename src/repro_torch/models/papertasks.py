"""The paper's four FL-task models (§5.1) — port of
``repro/models/papertasks.py``:

* IC  — Image Classification: ShuffleNet-style grouped blocks over feature
        vectors, 596 classes (OpenImage);
* SR  — Speech Recognition: ResNet-style residual MLP over audio features,
        35 classes (Google Speech Commands);
* TG  — Text Generation: two-cell LSTM language model (LEAF Shakespeare);
* MLM — Masked Language Modelling: RoBERTa-style bidirectional encoder with
        a masked-token objective (Reddit).

Models are plain functions of a param dict.  Every function also takes
*lane-stacked* inputs: params ``{k: [L, ...]}`` with a batch ``{k: [L, b,
...]}`` give per-lane losses ``[L]`` (the matmuls become batched GEMMs,
the embedding lookups one gather over the lanes' stacked tables), which is
how the round step trains its lanes side by side.  Unstacked inputs give a
scalar, as in the reference.

Two rules keep the backward deterministic on the card (the losses are
bitwise across pipeline depths): the gold log-prob is picked with a
one-hot product, never ``gather``, and an embedding lookup is plain
indexing, whose backward ``use_deterministic_algorithms`` makes ordered.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.layers import dense_init

__all__ = ["TaskModel", "TASK_MODELS", "make_task_model", "ic_init",
           "ic_forward", "sr_init", "sr_forward", "tg_init", "tg_forward",
           "mlm_init", "mlm_forward", "mlm_mask", "params_from_numpy",
           "params_to_numpy"]


def _xent(logits, labels, example_dims: int = 1):
    """Mean cross-entropy over the last ``example_dims`` dims of ``labels``
    (the batch, and the positions for a sequence task), per lane.  The gold
    log-prob is picked with a one-hot product instead of ``gather``, whose
    backward is a scatter-add: the product keeps the backward elementwise
    and deterministic on the card."""
    gold = _gold_logp(logits, labels)
    return -gold.mean(dim=tuple(range(-example_dims, 0)))


def _gold_logp(logits, labels):
    """``log_softmax(logits)[..., labels]`` by a one-hot product."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels.long().unsqueeze(-1) == classes).to(logp.dtype)
    return (logp * onehot).sum(-1)


def _mm(x, w):
    """``x @ w`` for ``x [*lead, ..., k]`` and ``w [*lead, k, n]``: the dims
    between the lanes and ``k`` fold into GEMM rows, so a lane-stacked
    product is one batched GEMM over the lanes."""
    lead = w.shape[:-2]
    rows = x.reshape(lead + (-1, x.shape[-1]))
    return (rows @ w).reshape(x.shape[:-1] + (w.shape[-1],))


def _lookup(table, tokens):
    """``table[tokens]`` per lane: ``table [*lead, V, d]``, ``tokens [*lead,
    ...]``.  The lanes' tables are one ``[L·V, d]`` table and each lane's
    tokens are offset into its block, so the lookup is one indexing op."""
    lead = table.shape[:-2]
    if not lead:
        return table[tokens]
    V = table.shape[-2]
    n = math.prod(lead)
    offs = (torch.arange(n, device=tokens.device) * V).reshape(
        lead + (1,) * (tokens.ndim - len(lead)))
    return table.reshape(n * V, table.shape[-1])[tokens.long() + offs]


# ---------------------------------------------------------------------------
# IC — ShuffleNet-style grouped blocks over feature vectors
# ---------------------------------------------------------------------------
def ic_init(gen: torch.Generator, *, input_dim=64, width=256, n_blocks=4,
            n_classes=596, groups=4, dtype=torch.float32) -> dict:
    p = {"stem": dense_init(gen, (input_dim, width), dtype)}
    gw = width // groups
    for i in range(n_blocks):
        # grouped pointwise convs (the ShuffleNetV2 motif on vector features)
        p[f"g1_{i}"] = dense_init(gen, (groups, gw, gw), dtype)
        p[f"g2_{i}"] = dense_init(gen, (groups, gw, gw), dtype)
    p["head"] = dense_init(gen, (width, n_classes), dtype)
    return p


def _channel_shuffle(x, groups):
    """``[..., b, w]``: interleave the groups' channels, lanes kept."""
    *lead, w = x.shape
    return (x.reshape(*lead, groups, w // groups).transpose(-1, -2)
            .reshape(*lead, w))


def ic_forward(p: dict, x: torch.Tensor, *, groups=4) -> torch.Tensor:
    relu = torch.relu
    h = relu(x @ p["stem"])
    n_blocks = sum(1 for k in p if k.startswith("g1_"))
    for i in range(n_blocks):
        *lead, w = h.shape
        hg = h.reshape(*lead, groups, w // groups)
        hg = relu(torch.einsum("...bgi,...gio->...bgo", hg, p[f"g1_{i}"]))
        hg = torch.einsum("...bgi,...gio->...bgo", hg, p[f"g2_{i}"])
        h = relu(h + _channel_shuffle(hg.reshape(*lead, w), groups))
    return h @ p["head"]


def _ic_loss(p, batch):
    return _xent(ic_forward(p, batch["x"]), batch["y"])


# ---------------------------------------------------------------------------
# SR — ResNet-34-style residual MLP
# ---------------------------------------------------------------------------
def sr_init(gen: torch.Generator, *, input_dim=64, width=512, n_blocks=8,
            n_classes=35, dtype=torch.float32) -> dict:
    p = {"stem": dense_init(gen, (input_dim, width), dtype)}
    for i in range(n_blocks):
        p[f"w1_{i}"] = dense_init(gen, (width, width), dtype)
        p[f"w2_{i}"] = dense_init(gen, (width, width), dtype)
    p["head"] = dense_init(gen, (width, n_classes), dtype)
    return p


def sr_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    relu = torch.relu
    h = relu(x @ p["stem"])
    n_blocks = sum(1 for k in p if k.startswith("w1_"))
    for i in range(n_blocks):
        z = relu(h @ p[f"w1_{i}"]) @ p[f"w2_{i}"]
        h = relu(h + z)
    return h @ p["head"]


def _sr_loss(p, batch):
    return _xent(sr_forward(p, batch["x"]), batch["y"])


# ---------------------------------------------------------------------------
# TG — two-cell LSTM LM (LEAF Shakespeare)
# ---------------------------------------------------------------------------
def tg_init(gen: torch.Generator, *, vocab=90, embed=8, hidden=256,
            n_cells=2, dtype=torch.float32) -> dict:
    p = {"embed": dense_init(gen, (vocab, embed), dtype, scale=0.05)}
    d_in = embed
    for i in range(n_cells):
        p[f"wx_{i}"] = dense_init(gen, (d_in, 4 * hidden), dtype)
        p[f"wh_{i}"] = dense_init(gen, (hidden, 4 * hidden), dtype)
        p[f"b_{i}"] = torch.zeros((4 * hidden,), dtype=dtype)
        d_in = hidden
    p["head"] = dense_init(gen, (hidden, vocab), dtype)
    return p


def _lstm_cell(p, i, xs):
    """xs ``[..., b, s, d_in]`` -> hs ``[..., b, s, hidden]``: the input
    projection of every position in one GEMM, then the recurrence as a loop
    over the positions (gates in the order i, f, g, o)."""
    wh = p[f"wh_{i}"]
    xw = _mm(xs, p[f"wx_{i}"])                    # [..., b, s, 4h]
    bias = p[f"b_{i}"].unsqueeze(-2)              # [..., 1, 4h]
    h = c = xs.new_zeros(xs.shape[:-2] + (wh.shape[-2],))
    hs = []
    for t in range(xs.shape[-2]):
        gates = xw[..., t, :] + h @ wh + bias
        ii, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(ii) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=-2)


def tg_forward(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = _lookup(p["embed"], tokens)
    n_cells = sum(1 for k in p if k.startswith("wx_"))
    for i in range(n_cells):
        x = _lstm_cell(p, i, x)
    return _mm(x, p["head"])


def _tg_loss(p, batch):
    toks = batch["tokens"]
    return _xent(tg_forward(p, toks[..., :-1]), toks[..., 1:],
                 example_dims=2)


# ---------------------------------------------------------------------------
# MLM — RoBERTa-style bidirectional encoder with masked-token loss
# ---------------------------------------------------------------------------
def mlm_init(gen: torch.Generator, *, vocab=30_000, d_model=256, n_layers=4,
             n_heads=4, d_ff=1024, dtype=torch.float32) -> dict:
    L = n_layers
    p = {"embed": dense_init(gen, (vocab, d_model), dtype, scale=0.02)}
    sq = (d_model, d_model)
    for name, shape in (("wq", sq), ("wk", sq), ("wv", sq), ("wo", sq),
                        ("w_up", (d_model, d_ff)),
                        ("w_down", (d_ff, d_model))):
        p[name] = dense_init(gen, (L,) + shape, dtype)
    p["ln1"] = torch.ones((L, d_model), dtype=dtype)
    p["ln2"] = torch.ones((L, d_model), dtype=dtype)
    return p


def _rms(x, scale):
    """RMS norm of ``x [..., b, s, d]`` by a per-lane ``scale [..., d]``."""
    s = scale.unsqueeze(-2).unsqueeze(-2)
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6) * s


def mlm_forward(p: dict, tokens: torch.Tensor, *, n_heads: int = 4
                ) -> torch.Tensor:
    x = _lookup(p["embed"], tokens)                # [..., b, s, d]
    *lead, b, s, d = x.shape
    hd = d // n_heads

    def heads(y):
        return y.reshape(*lead, b, s, n_heads, hd)

    for i in range(p["wq"].shape[-3]):
        # Layer i of every stacked [..., n_layers, ...] leaf.
        wq, wk, wv, wo, wu, wd = (p[k].select(-3, i) for k in (
            "wq", "wk", "wv", "wo", "w_up", "w_down"))
        h = _rms(x, p["ln1"].select(-2, i))
        q, k, v = heads(_mm(h, wq)), heads(_mm(h, wk)), heads(_mm(h, wv))
        sc = torch.einsum("...snd,...tnd->...nst", q, k) / math.sqrt(hd)
        a = torch.softmax(sc, -1)
        o = torch.einsum("...nst,...tnd->...snd", a, v).reshape(
            *lead, b, s, d)
        x = x + _mm(o, wo)
        h = _rms(x, p["ln2"].select(-2, i))
        # jax.nn.gelu's default is the tanh approximation.
        x = x + _mm(F.gelu(_mm(h, wu), approximate="tanh"), wd)
    return _mm(x, p["embed"].transpose(-1, -2))


def mlm_mask(tokens: torch.Tensor, mask_rate: float = 0.15) -> torch.Tensor:
    """The reference's deterministic pseudo-mask ``(toks * 2_654_435 % 100)
    < 15``, computed there on int32 tokens: the product wraps for every
    token >= 810 and ``%`` is floor-mod.  The product is formed in int64
    and wrapped to int32 explicitly (torch leaves int32 overflow to the
    compiler), then floor-modded as the reference does."""
    prod = tokens.long() * 2_654_435
    wrapped = (prod + 2**31) % 2**32 - 2**31
    return torch.remainder(wrapped, 100) < int(mask_rate * 100)


def _mlm_loss(p, batch, *, mask_rate=0.15, mask_token=3):
    toks = batch["tokens"]
    mask = mlm_mask(toks, mask_rate)
    inp = torch.where(mask, torch.full_like(toks, mask_token), toks)
    gold = _gold_logp(mlm_forward(p, inp), toks)
    m = mask.to(gold.dtype)
    dims = (-2, -1)
    return -(gold * m).sum(dims) / torch.clamp(m.sum(dims), min=1.0)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TaskModel:
    name: str
    init: Callable
    loss_fn: Callable            # (params, batch) -> loss ([L] when stacked)
    target_bytes: float          # paper Table 6 model size (MB -> bytes)
    kind: str                    # 'labelled' | 'tokens'


TASK_MODELS = {
    "ic": TaskModel("ic", ic_init, _ic_loss, 26.45e6, "labelled"),
    "sr": TaskModel("sr", sr_init, _sr_loss, 85.14e6, "labelled"),
    "tg": TaskModel("tg", tg_init, _tg_loss, 3.28e6, "tokens"),
    "mlm": TaskModel("mlm", mlm_init, _mlm_loss, 60.37e6, "tokens"),
}


def make_task_model(task: str, seed: int = 1337, *, device=None, **kw):
    """Returns (params, loss_fn) for one of the paper's four tasks, params
    on ``device`` (``cuda`` unless ``device="cpu"`` is passed).  TG and MLM
    default to a 32,000-token vocab, as in the reference.

    The weights come from a ``torch.Generator`` seeded with ``seed``; they
    differ from the reference's ``jax.random`` init by design.  Tests that
    compare the two packages hand the reference's weights over with
    :func:`params_from_numpy`.
    """
    tm = TASK_MODELS[task]
    if task in ("tg", "mlm"):
        kw.setdefault("vocab", 32_000)
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    params = {k: v.to(device) for k, v in tm.init(gen, **kw).items()}
    return params, tm.loss_fn


def params_from_numpy(params: dict, device=None) -> dict:
    """``{name: ndarray}`` -> ``{name: Tensor}`` on ``device`` (copied;
    ``cuda`` unless ``device="cpu"`` is passed)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in params.items()}


def params_to_numpy(params: dict) -> dict:
    """Inverse of :func:`params_from_numpy`."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
