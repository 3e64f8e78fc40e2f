"""The frozen counts against numbers worked out by hand (CPU only)."""

import pytest

from perfbench.reference import qwen3, sr
from perfbench.work import counts

QWEN3 = {"num_hidden_layers": 28, "hidden_size": 1024,
         "num_attention_heads": 16, "num_key_value_heads": 8, "head_dim": 128,
         "intermediate_size": 3072, "vocab_size": 151_936,
         "model": "qwen3", "assumed": {"seq_len": 256}}
SR = {"model": "sr", "input_dim": 64, "width": 512, "n_blocks": 8,
      "n_classes": 35}


def test_k1_bytes_over_two_qwen3_lanes():
    """K1 over ``[2, 596,180,992]`` f32 (the port's Qwen3-0.6B with its
    vocabulary padded to 152,064 rows) moves 3 × 2 × 596,180,992 × 4 =
    14.31 GB when both lanes fold, as PERF.md's kernel table counts it;
    the least it moves, ``acc`` in and out, is two thirds of that:
    9.54 GB."""
    assert 3 * 2 * 596_180_992 * 4 == 14_308_343_808
    assert counts.fedavg_accum_bytes(2, 596_180_992, "float32") == \
        9_538_895_872
    assert counts.fedavg_accum_bytes(4, 10, "bfloat16") == 160


def test_sr_params_and_step():
    """64·512 + 16·512² + 512·35 = 4,244,992 parameters; a step over a
    batch of 20 is 6 × 4,244,992 × 20 = 509,399,040 FLOPs."""
    n = sum(a * b for a, b in sr.shapes(SR).values())
    assert n == 4_244_992
    assert counts.step_flops(SR, 20) == 509_399_040


def test_qwen3_params_and_step():
    """Per layer: wq 1024·2048 + wk, wv 2 · 1024·1024 + wo 2048·1024 +
    gate, up, down 3 · 1024·3072 = 15,728,640; norms 2·1024 + 2·128.
    28 layers, the embedding 151,936 · 1024 and the final norm: 596,049,920
    parameters (the port's padded embedding adds 128 rows: 596,180,992).

    A step over 8 × 256 tokens:
    * the layers' matrices: 6 · 28 · 15,728,640 · 2,048 = 5.412e12;
    * the tied head: 6 · 1024 · 151,936 · 8 · 255 = 1.904e12;
    * attention: 3 (forward and backward) · 4 · 28 layers · 16 heads ·
      128 · (256·257/2 pairs) · 8 sequences = 1.811e11;
    in all 7.497e12 FLOPs."""
    shapes = qwen3.shapes(QWEN3)
    n = 0
    for s in shapes.values():
        p = 1
        for d in s:
            p *= d
        n += p
    assert n == 596_049_920
    dense = 6 * 28 * 15_728_640 * 2048
    head = 6 * 1024 * 151_936 * 8 * 255
    attn = 3 * 4 * 28 * 16 * 128 * (256 * 257 // 2) * 8
    assert (dense, head, attn) == (5_411_658_792_960, 1_904_329_359_360,
                                   181_093_269_504)
    assert counts.step_flops(QWEN3, 8) == pytest.approx(
        dense + head + attn, rel=1e-12)
    assert counts.step_flops(QWEN3, 8) == pytest.approx(7.4971e12, rel=1e-4)


def test_peaks_are_the_data_sheet():
    assert counts.PEAK_FLOPS["bfloat16"] == 989e12
    assert counts.PEAK_FLOPS["float32"] == 67e12
    assert counts.HBM_BYTES_PER_S == 3.35e12
