"""The check that decides ``correct``, on the CPU at sizes a test run
holds: the plain reference agrees with the port's engine; a run whose
timed path is broken comes out not correct; the control (the reference in
the precision below the configuration's) fails the cell's limits."""

import pytest
import torch

from perfbench import control, harness
from perfbench.reference.compare import loss_gaps, numbers
from perfbench.reference.lowp import QUANTISERS
from perfbench.weights import make_weights
from repro_torch.core import engine as engine_mod

SR = "sr.u1024.w4l128"
SEED = 2 ** 31 + 11


def _small(name, **traffic):
    cell = harness.load_cell(name)
    cell["traffic"].update(dict(cohort=2, workers=1, lanes_per_worker=2,
                                steps_cap=2, warmup_rounds=2), **traffic)
    return cell


def _qwen3_tiny(dtype):
    cell = harness.parts("qwen3-0.6b", "u8.w2l2")
    cell["traffic"].update(cohort=2, workers=1, lanes_per_worker=2,
                           steps_cap=2, warmup_rounds=2)
    cell["config"].update(num_hidden_layers=2, hidden_size=64,
                          intermediate_size=128, num_attention_heads=4,
                          num_key_value_heads=2, head_dim=16, vocab_size=500,
                          torch_dtype=dtype)
    cell["config"]["data"].update(vocab_size=500)
    return cell


def _correct(check):
    return all(v <= lim for v, lim in check.values())


def test_sr_reference_agrees_with_the_engine():
    run, check = harness.run_cell(_small(SR), seed=SEED, seconds=0.1,
                                  trace=False, device="cpu")
    assert _correct(check), check
    assert len(run.window) >= 2


@pytest.mark.parametrize("q", [None, "tf32"])
def test_sr_every_round_agrees_at_the_test_size(q):
    """A witness for the rounds after the first, which the cell's check
    does not compare by loss: at a cohort of 8 on 2 x 2 lanes, 3 rounds,
    every round's loss of the program is the reference's within 1e-5
    (0.2e-7 to 1.7e-6 read), while the reference in TF32 in the program's
    place reads 6.8e-5 or more on rounds 2 and 3 as well as on round 1."""
    cell = _small(SR, cohort=8, workers=2, steps_cap=3, warmup_rounds=3)
    cfg, traffic = cell["config"], cell["traffic"]
    theta0, prog = control.program_readings(cell, SEED, "cpu")
    ref = harness.reference_readings(cfg, traffic, SEED, theta0, "cpu", 3)
    if q is None:
        assert max(loss_gaps(prog, ref)) < 1e-5, loss_gaps(prog, ref)
    else:
        ctl = harness.reference_readings(cfg, traffic, SEED, theta0, "cpu",
                                         3, q=QUANTISERS[q])
        assert min(loss_gaps(ctl, ref)) > 1e-5, loss_gaps(ctl, ref)


def test_qwen3_reference_agrees_with_the_engine_in_float32():
    """Two layers at reduced widths, the vocabulary padded by the program:
    in float32 every number agrees to rounding."""
    cell = _qwen3_tiny("float32")
    theta0, prog = control.program_readings(cell, SEED, "cpu")
    ref = harness.reference_readings(cell["config"], cell["traffic"], SEED,
                                     theta0, "cpu", 2)
    got = numbers(theta0, prog, ref)
    assert max(got.values()) < 1e-4, got


def test_qwen3_losses_agree_in_bfloat16():
    cell = _qwen3_tiny("bfloat16")
    theta0, prog = control.program_readings(cell, SEED, "cpu")
    ref = harness.reference_readings(cell["config"], cell["traffic"], SEED,
                                     theta0, "cpu", 2)
    assert numbers(theta0, prog, ref)["loss1_gap"] < 1e-3


def _broken_step(kind):
    real = engine_mod.make_round_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def broken(params, batches, step_mask, boundary, weight):
            if kind == "half_batch":
                batches = {k: v[:, :, :, : v.shape[3] // 2]
                           for k, v in batches.items()}
            new, metrics = step(params, batches, step_mask, boundary, weight)
            if kind == "state_unchanged":
                new = params
            if kind == "answer_altered":
                metrics = metrics._replace(loss=metrics.loss * 1.01)
            return new, metrics

        return broken

    return make


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "answer_altered"])
def test_a_broken_timed_path_is_not_correct(kind, monkeypatch):
    """The harness's run with the round step broken underneath — its
    state returned unchanged, half of every batch left out, its loss
    altered where it is produced — comes out not correct."""
    monkeypatch.setattr(engine_mod, "make_round_step", _broken_step(kind))
    _, check = harness.run_cell(_small(SR), seed=SEED, seconds=0.1,
                                trace=False, device="cpu")
    assert not _correct(check), check


def test_sr_control_fails_the_limits():
    """The reference in TF32 in the program's place fails the cell's
    limits on at least one number."""
    cell = _small(SR, cohort=4, lanes_per_worker=4)
    cfg, traffic = cell["config"], cell["traffic"]
    theta0 = {k: v.cpu() for k, v in make_weights(cfg, SEED, "cpu").items()}
    ref = harness.reference_readings(cfg, traffic, SEED, theta0, "cpu", 2)
    ctl = harness.reference_readings(cfg, traffic, SEED, theta0, "cpu", 2,
                                     q=QUANTISERS["tf32"])
    got = numbers(theta0, ctl, ref)
    assert any(got[k] > cell["limits"][k] for k in got), got


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -3.0],
                     dtype=torch.float32)
    y = QUANTISERS["tf32"](x)
    assert y.tolist() == [1.0, 1.0 + 2 ** -9, -3.0]
