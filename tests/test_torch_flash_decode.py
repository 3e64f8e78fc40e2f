"""The flash-decode combine on one process: a decode step's cache split
into ``m`` blocks of slots, :func:`layers.decode_attention_partial` over
each block and :func:`layers.combine_decode_partials` over the blocks
(``pmax``/``psum`` as a maximum and a sum over the list) against
:func:`layers.decode_attention` over the whole cache.

The shapes are a GQA group of 4 (8 query heads, 2 kv heads) and of 1, a
mask that leaves the last block without a valid slot (as a rank whose
slots all lie past ``pos``), one that leaves none empty, per-sequence
masks, and no mask (cross-attention).  f32 within 1e-5; bf16 within 2e-2
(the whole-cache path rounds its probabilities to bf16 before the value
product, the combine keeps them in f32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models.layers import (combine_decode_partials,  # noqa: E402
                                       decode_attention,
                                       decode_attention_partial)

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
B, T, HD = 3, 24, 16


def _inputs(dtype, hq, hkv, seed):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    return draw(B, 1, hq, HD), draw(B, T, hkv, HD), draw(B, T, hkv, HD)


def _mask(kind):
    """``[T]`` or ``[B, T]`` valid-slot marks, or None."""
    if kind == "none":
        return None
    if kind == "last_block_empty":          # pos in the first half
        return (torch.arange(T) <= 9).float()
    if kind == "full":
        return torch.ones(T)
    pos = torch.tensor([3, 15, 23])[:, None]    # per sequence
    return (torch.arange(T)[None, :] <= pos).float()


def _combined(q, k, v, mask, m):
    """Each of the m blocks' partials, and the combine each block's rank
    computes: the maxima's maximum, and the sum of what every rank sends
    to the sum (gathered in a first pass)."""
    n = T // m
    parts = [decode_attention_partial(
        q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n],
        None if mask is None else mask[..., r * n:(r + 1) * n])
        for r in range(m)]
    top = torch.stack([p[0] for p in parts]).amax(dim=0)
    sent = []
    for p in parts:
        combine_decode_partials(*p, pmax=lambda _: top,
                                psum=lambda t: sent.append(t) or t)
    total = torch.stack(sent).sum(dim=0)
    outs = [combine_decode_partials(*p, pmax=lambda _: top,
                                    psum=lambda _: total) for p in parts]
    return outs, parts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)], ids=["gqa4", "mha"])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("mask", ["last_block_empty", "full", "per_seq",
                                  "none"])
def test_combine_equals_whole_cache(dtype, hq, hkv, m, mask):
    q, k, v = _inputs(dtype, hq, hkv, seed=hq + 10 * m)
    mk = _mask(mask)
    want = decode_attention(q, k, v, mk)
    outs, parts = _combined(q, k, v, mk, m)
    for out in outs:                         # every rank's result
        assert out.dtype == torch.float32 and out.shape == want.shape
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out.numpy(), want.float().numpy(),
                                   **TOL[dtype])
    if mask == "last_block_empty":
        m_last, l_last, o_last = parts[-1]
        assert bool((m_last == torch.finfo(torch.float32).min).all())
        assert not l_last.any() and not o_last.any()


def test_one_block_is_decode_attention():
    """One block with the identity reductions: ``decode_attention`` in
    f32 to rounding."""
    q, k, v = _inputs(torch.float32, 8, 2, seed=3)
    mk = _mask("per_seq")
    got = combine_decode_partials(*decode_attention_partial(q, k, v, mk))
    np.testing.assert_allclose(got.numpy(), decode_attention(q, k, v,
                                                             mk).numpy(),
                               rtol=1e-6, atol=1e-6)
