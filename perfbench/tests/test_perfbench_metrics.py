"""The metric arithmetic on made-up records (CPU only): rates over all
the window's work and time, the tail over all its rounds, the readers of
the trace, and readers that find nothing."""

from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.metrics import (device_idle, device_ms_per_step,
                               exec_ms_per_step, exposed_pack_ms, k1_roofline,
                               mfu, pack_ms, peak_mem_gib)
from perfbench.work import counts

CELL = harness.load_cell("sr.u1024.w4l128")


def _round(wall, S=16, padded=1000, pack=0.01, overlap=0.9, exec_s=0.2):
    return SimpleNamespace(wall_time=wall, s_steps=S, padded_steps=padded,
                           pack_time=pack, overlap_fraction=overlap,
                           exec_time=exec_s, loss=1.0)


def _run(rounds, window_s, trace=None, lanes=128):
    return harness.Run(cell=CELL, lanes=lanes, window=rounds,
                       window_s=window_s, setup_s=12.5, peak_bytes=3 * 2 ** 30,
                       group_elems={"float32": 4_244_992}, trace=trace)


def test_rate_is_all_steps_over_all_time():
    rounds = [_round(0.25) for _ in range(40)]
    e2e = harness.read_metrics(_run(rounds, window_s=10.0), CELL["end_to_end"])
    real = 128 * 16 - 1000
    assert e2e["client_steps_per_s"]["value"] == pytest.approx(
        40 * real / 10.0)
    assert e2e["setup_s"]["value"] == 12.5
    assert e2e["peak_mem_gib"]["value"] == 3.0
    assert set(e2e) == {"client_steps_per_s", "peak_mem_gib", "setup_s"}


def test_a_stalled_round_moves_the_rate():
    """One round that stalls for 3 s lengthens the window by 3 s, and the
    rate falls by that share: the rate is all the work over all the time,
    not a mean of per-round rates."""
    calm = [_round(0.25) for _ in range(20)]
    stalled = calm[:19] + [_round(3.25)]
    a = harness.read_metrics(_run(calm, window_s=5.0), CELL["end_to_end"])
    b = harness.read_metrics(_run(stalled, window_s=8.0), CELL["end_to_end"])
    assert b["client_steps_per_s"]["value"] == pytest.approx(
        a["client_steps_per_s"]["value"] * 5.0 / 8.0)


def test_host_readers():
    rounds = [_round(0.3, pack=0.02, overlap=0.75, exec_s=0.32)
              for _ in range(5)]
    run = _run(rounds, window_s=1.5)
    assert pack_ms.read(run) == pytest.approx(20.0)
    assert exposed_pack_ms.read(run) == pytest.approx(5.0)
    assert exec_ms_per_step.read(run) == pytest.approx(320.0 / 16)
    flops = 5 * (128 * 16 - 1000) * counts.sr_step_flops(CELL["config"], 20)
    assert mfu.read(run) == pytest.approx(
        100 * flops / (1.5 * counts.PEAK_FLOPS["float32"]))


def _trace(kernels, t0=0.0, t1=1.0, rounds=()):
    return harness.Trace(kernels=kernels, t0=t0, t1=t1,
                         busy=harness._union(kernels, t0, t1),
                         rounds=list(rounds))


def test_trace_readers():
    n = 4_244_992
    k1_s = counts.fedavg_accum_bytes(128, n, "float32") / \
        counts.HBM_BYTES_PER_S / 0.8          # at 80 % of its bound
    kernels = [("gemm", 0.0, 0.2), ("gemm", 0.1, 0.2),
               ("fedavg_accum_f32(float const*)", 0.5, k1_s)]
    tr = _trace(kernels, rounds=[_round(0.5, S=8), _round(0.5, S=8)])
    run = _run(tr.rounds, 1.0, trace=tr)
    busy = 0.3 + k1_s
    assert tr.busy_s == pytest.approx(busy)
    assert device_idle.read(run) == pytest.approx(100 * (1 - busy))
    assert device_ms_per_step.read(run) == pytest.approx(1e3 * busy / 16)
    assert k1_roofline.read(run) == pytest.approx(80.0)


def test_readers_that_find_nothing():
    run = _run([_round(0.3)], window_s=0.3)
    for reader in (device_idle, device_ms_per_step, k1_roofline):
        assert reader.read(run) is None
    empty = _run([], window_s=0.0)
    for reader in (pack_ms, exposed_pack_ms, exec_ms_per_step, mfu):
        assert reader.read(empty) is None
    empty.peak_bytes = 0              # a run on the CPU reads no peak
    assert peak_mem_gib.read(empty) is None
    tr = _trace([("gemm", 0.0, 0.5)], rounds=[_round(0.5)])
    assert k1_roofline.read(_run(tr.rounds, 1.0, trace=tr)) is None


def test_idle_gaps_labelled_by_engine_span():
    kernels = [("gemm", 0.0, 0.2), ("gemm", 0.5, 0.5)]
    tr = _trace(kernels, rounds=[_round(1.0)])
    run = _run(tr.rounds, 1.0, trace=tr)
    run.spans = [("X", "exec.wait", 0.15, 0.4, "MainThread", 0, None),
                 ("X", "prep.pack", 0.1, 0.5, "pollen-pack_0", 0, None)]
    out = harness.breakdown(run)
    assert out["device_ops"] == [["gemm", pytest.approx(0.7)]]
    assert out["idle_gaps"] == [["exec.wait", pytest.approx(0.3)]]


def test_idle_gaps_prefer_the_main_thread_then_the_innermost_span():
    """Gaps in no span are the host's; a gap in a main-thread span goes to
    it over the producer's, and to the innermost of nested spans."""
    kernels = [("k", 0.0, 0.1), ("k", 0.2, 0.1), ("k", 0.4, 0.1),
               ("k", 0.6, 0.1)]
    tr = _trace(kernels, t0=0.0, t1=0.7, rounds=[_round(0.7)])
    run = _run(tr.rounds, 0.7, trace=tr)
    run.spans = [("X", "exec.dispatch", 0.1, 0.35, "MainThread", 0, None),
                 ("X", "exec.wait", 0.12, 0.1, "MainThread", 0, None),
                 ("X", "prep.pack", 0.0, 0.45, "pollen-pack_0", 0, None)]
    gaps = dict(harness.breakdown(run)["idle_gaps"])
    assert gaps == {"exec.wait": pytest.approx(0.1),
                    "exec.dispatch": pytest.approx(0.1),
                    "host (no engine span)": pytest.approx(0.1)}
