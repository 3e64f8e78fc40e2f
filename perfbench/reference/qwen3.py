"""Qwen3's dense decoder written out plainly, for next-token training
(Qwen3 technical report, arXiv:2505.09388; ``hf:Qwen/Qwen3-0.6B``'s
``config.json``).

Per layer: ``x += o_proj(attn(rope(q_norm(q)), rope(k_norm(k)), v))`` on
the RMS-normed stream, grouped-query attention with ``num_key_value_heads``
key/value heads, causal, scaled by ``1/sqrt(head_dim)``; then ``x +=
down(silu(gate(h)) * up(h))`` on the normed stream.  A final RMSNorm, and
logits against the tied embedding.  RoPE rotates the two halves of each
head (not interleaved) with frequencies ``rope_theta^(-2i/head_dim)``.

Precision as the configuration states it: matrices and the residual
stream in ``torch_dtype`` (bfloat16), RMSNorm, RoPE and softmax computed
in float32, the RMSNorm scales float32, the logits and the cross-entropy
float32.

Leaves (the layers stacked on a leading ``num_hidden_layers`` dim):
``embed [V, D]``, ``final_norm [D]``, ``attn_norm``, ``wq [D, H·hd]``,
``wk``, ``wv [D, Hkv·hd]``, ``wo [H·hd, D]``, ``q_norm``, ``k_norm
[hd]``, ``mlp_norm``, ``w_gate``, ``w_up [D, F]``, ``w_down [F, D]``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.lowp import matmul

__all__ = ["shapes", "loss", "NORMS", "STACK"]

STACK = 1          # clients trained one by one (fl.py): a client's model
                   # at published widths fills a good part of the card

NORMS = ("final_norm", "attn_norm", "q_norm", "k_norm", "mlp_norm")


def shapes(cfg: dict) -> dict:
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, Fd, V = cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"]
    return {"embed": (V, D), "final_norm": (D,),
            "attn_norm": (L, D), "wq": (L, D, H * hd), "wk": (L, D, Hkv * hd),
            "wv": (L, D, Hkv * hd), "wo": (L, H * hd, D),
            "q_norm": (L, hd), "k_norm": (L, hd), "mlp_norm": (L, D),
            "w_gate": (L, D, Fd), "w_up": (L, D, Fd), "w_down": (L, Fd, D)}


def _rms(x, scale, eps):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _rope(x, theta):
    s, hd = x.shape[1], x.shape[-1]
    inv = torch.exp(-torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=x.device) / hd * math.log(theta))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _attention(q, k, v):
    """q ``[b, s, H, hd]``, k/v ``[b, s, Hkv, hd]``: causal softmax
    attention, each query head reading its group's key/value head."""
    b, s, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
    return torch.einsum("bhst,bthd->bshd", probs.to(q.dtype), v)


def loss(p: dict, batch: dict, cfg: dict, q=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"] [b, s]``; for
    leaves and tokens ``[C, b, s]`` stacked by client, one per client."""
    if batch["tokens"].ndim == 3:
        return torch.stack([
            loss({k: v[c] for k, v in p.items()},
                 {k: v[c] for k, v in batch.items()}, cfg, q)
            for c in range(batch["tokens"].shape[0])])
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    hd = cfg["head_dim"]
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = p["embed"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        h = _rms(x, p["attn_norm"][i], eps)
        qh = matmul(h, p["wq"][i], q).reshape(b, s, -1, hd)
        kh = matmul(h, p["wk"][i], q).reshape(b, s, -1, hd)
        vh = matmul(h, p["wv"][i], q).reshape(b, s, -1, hd)
        qh = _rope(_rms(qh, p["q_norm"][i], eps), theta)
        kh = _rope(_rms(kh, p["k_norm"][i], eps), theta)
        a = _attention(qh, kh, vh).reshape(b, s, -1)
        x = x + matmul(a, p["wo"][i], q)
        h = _rms(x, p["mlp_norm"][i], eps)
        z = F.silu(matmul(h, p["w_gate"][i], q)) * matmul(h, p["w_up"][i], q)
        x = x + matmul(z, p["w_down"][i], q)
    h = _rms(x, p["final_norm"], eps)[:, :-1]
    logits = matmul(h.float(), p["embed"].float().t(), q)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))
