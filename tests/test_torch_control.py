"""The port's closed-loop control plane and concurrency estimator against
the JAX reference, and the reference's control invariants inside the port.

* The copied numpy modules (``control/*``, ``simcluster/*``,
  ``core/concurrency.py``) give results equal to the reference's: every
  scenario of ``SCENARIOS``, the simcluster Table 3 concurrency and
  framework experiments, the slot estimators and the VRAM rule.
* In synthetic mode — the controller idle, adapting, or falling back to
  BB — the port's engine makes the reference's per-round assignments, its
  control stats, slot moves and ``drift_fallback`` flags exactly, and its
  losses agree to rtol 1e-5 (the SR system parity tolerance of
  ``tests/test_torch_engine.py``: GEMM sums in another order).
* Measured mode (times from the port's own clock) keeps the reference's
  protocol guarantee: no prep consumes telemetry of an unfinished round,
  at depths 0/1/2 under ``reuse`` and ``stall``; a stalled producer wakes
  on abort and on a device failure; synthetic-mode losses are
  bit-identical across depths with the controller live; the controller's
  state survives a checkpoint (``tests/test_control.py`` on the port).
"""

import tempfile
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_parity as par  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401
from repro import control as jctl  # noqa: E402
from repro import simcluster as jsim  # noqa: E402
from repro.core import concurrency as jconc  # noqa: E402
from repro.data import make_federated_dataset  # noqa: E402
from repro_torch import control as tctl  # noqa: E402
from repro_torch import simcluster as tsim  # noqa: E402
from repro_torch.control import (AdaptiveConcurrency, DriftDetector,  # noqa: E402
                                 MeasuredTelemetry, audit_violations)
from repro_torch.core import EngineConfig  # noqa: E402
from repro_torch.core import concurrency as tconc  # noqa: E402
from repro_torch.core import make_placement  # noqa: E402

SR_LOSS_RTOL = 1e-5
# The controller idle (a threshold no residual reaches), hill-climbing the
# slot count, and on a hair trigger that falls back to BB mid-run.
CONTROL_MODES = {"idle": dict(drift_threshold=1e9),
                 "adapting": dict(adapt_interval=2),
                 "fallback": dict(drift_threshold=0.01)}


def _engine(depth=1, **cfg):
    """``tests/test_control.py``'s engine on the port (the system-test SR
    engine: cohort 8 over 2 workers x 2 lanes)."""
    return par.system_engine(True, depth=depth, **cfg)


# -- the copied modules, against the reference ---------------------------------
@pytest.mark.parametrize("name", list(jctl.SCENARIOS))
def test_scenarios_match_the_reference(name):
    assert list(tctl.SCENARIOS) == list(jctl.SCENARIOS)
    assert tctl.run_scenario(name) == jctl.run_scenario(name)


def test_simcluster_concurrency_and_frameworks_match_the_reference():
    """Table 3's worker expansion (Pollen, one worker per GPU, Flower's
    uniform level) and every framework's experiment on both clusters."""
    ds = make_federated_dataset("ic")

    def sampler(seed=7):
        rng = np.random.default_rng(seed)
        return lambda r: [ds.n_batches(int(c))
                          for c in rng.choice(ds.n_clients, size=60)]

    for task in ("ic", "mlm"):
        for kw in ({}, {"one_worker_per_gpu": True},
                   {"uniform_concurrency": True}):
            j = jsim.engine.make_workers(jsim.multi_node(), jsim.TASKS[task],
                                         **kw)
            t = tsim.engine.make_workers(tsim.multi_node(), tsim.TASKS[task],
                                         **kw)
            assert [vars(w) for w in t] == [vars(w) for w in j]
    assert list(tsim.FRAMEWORKS) == list(jsim.FRAMEWORKS)
    for fw in jsim.FRAMEWORKS:
        for cluster in ("single_node", "multi_node"):
            j = jsim.run_experiment(fw, jsim.TASKS["ic"],
                                    getattr(jsim, cluster)(), sampler(),
                                    rounds=4)
            t = tsim.run_experiment(fw, tsim.TASKS["ic"],
                                    getattr(tsim, cluster)(), sampler(),
                                    rounds=4)
            assert [vars(r) for r in t.rounds] == [vars(r) for r in j.rounds]
            assert t.total_time == j.total_time


def test_concurrency_estimators_match_the_reference():
    spec = dict(name="card", hbm_bytes=24 * 2**30, peak_flops=1e14,
                hbm_bw=1e12, ici_bw=0.0, vmem_bytes=0,
                reserved_fraction=0.08)
    jd, td = jconc.DeviceSpec(**spec), tconc.DeviceSpec(**spec)
    for pb, opt, act, group in ((17 << 20, 1.0, 1 << 28, 1),
                                (2 << 30, 2.0, 3 << 30, 4),
                                (30 << 30, 2.0, 1 << 30, 1)):
        kw = dict(param_bytes=pb, optimizer_bytes_per_param_byte=opt,
                  activation_bytes=act, group_devices=group, max_slots=64)
        assert vars(tconc.estimate_slots_analytic(device=td, **kw)) == \
            vars(jconc.estimate_slots_analytic(device=jd, **kw))

    class Mem:
        argument_size_in_bytes = 40 << 20
        output_size_in_bytes = 17 << 20
        temp_size_in_bytes = 300 << 20

    for slots in (1, 2, 8):
        kw = dict(slots_compiled=slots, group_devices=1, max_slots=64)
        assert vars(tconc.estimate_slots_from_memory_analysis(
            Mem(), device=td, **kw)) == vars(
            jconc.estimate_slots_from_memory_analysis(Mem(), device=jd, **kw))
    # a backend without the analysis stays at the compiled slot count
    assert vars(tconc.estimate_slots_from_memory_analysis(
        object(), slots_compiled=3, group_devices=1)) == vars(
        jconc.estimate_slots_from_memory_analysis(
            object(), slots_compiled=3, group_devices=1))
    for args in ((48 << 30, 1 << 30, 0.03), (11 << 30, 3 << 30, 0.5),
                 (80 << 30, 1, 1e-9)):
        assert tconc.gpu_concurrency_probe(*args) == \
            jconc.gpu_concurrency_probe(*args)


def test_device_spec_describes_the_card_not_a_tpu():
    spec = tconc.DeviceSpec()
    assert "H100" in spec.name and spec.hbm_bytes == 80 * 10**9
    assert spec.peak_flops == 989e12 and spec.hbm_bw == 3.35e12
    assert spec.ici_bw == 0.0 and spec.vmem_bytes == 0
    assert [f for f in vars(spec)] == [f for f in vars(jconc.DeviceSpec())]


def test_memory_probe_raises_on_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA allocator"):
        tconc.round_memory_analysis(_engine(), slots_compiled=2)


# -- the engine against the reference, synthetic mode --------------------------
def _spy_assignments(eng) -> list:
    """Record every round's assignment ``{wid: [cid]}``, from LB and from
    the controller's BB fallback."""
    log: list = []

    def wrap(placement):
        orig = placement.assign

        def assign(clients, workers):
            a = orig(clients, workers)
            log.append({w: [c.cid for c in cs]
                        for w, cs in sorted(a.per_worker.items())})
            return a

        placement.assign = assign

    wrap(eng.placement)
    if eng.control is not None:
        wrap(eng.control.fallback_placement)
    return log


@pytest.mark.parametrize("mode", list(CONTROL_MODES))
def test_synthetic_control_matches_the_reference(mode):
    jeng = par.system_engine(False, **CONTROL_MODES[mode])
    teng = par.system_engine(True, **CONTROL_MODES[mode])
    jlog, tlog = _spy_assignments(jeng), _spy_assignments(teng)
    jres, tres = jeng.run(8), teng.run(8)
    assert tlog == jlog and len(tlog) == 8
    assert teng.control_stats == jeng.control_stats
    assert teng.control.log == jeng.control.log
    assert [r.drift_fallback for r in tres] == \
        [r.drift_fallback for r in jres]
    for j, t in zip(jres, tres):
        assert (t.makespan, t.idle_time, t.slo_p50, t.slo_p99) == \
            (j.makespan, j.idle_time, j.slo_p50, j.slo_p99)
        np.testing.assert_allclose(t.loss, j.loss, rtol=SR_LOSS_RTOL)
    assert {w.wid: w.concurrency for w in teng.pool.snapshot()} == \
        {w.wid: w.concurrency for w in jeng.pool.snapshot()}
    if mode == "adapting":
        assert teng.control.autoconc.updates > 0
        assert teng.control.autoconc.trajectory == \
            jeng.control.autoconc.trajectory
    if mode == "fallback":
        assert any(r.drift_fallback for r in tres)
    if mode == "idle":
        assert not any(r.drift_fallback for r in tres)


# -- the reference's invariants, inside the port ---------------------------------
def test_abort_wakes_stalled_producer():
    mt = MeasuredTelemetry(policy="stall", stall_timeout_s=30.0)
    mt.begin_run(0)
    done = threading.Event()

    def producer():
        mt.flush(5)
        done.set()

    th = threading.Thread(target=producer)
    th.start()
    time.sleep(0.05)
    mt.abort()
    assert done.wait(timeout=10)
    th.join()


@pytest.mark.parametrize("policy", ["reuse", "stall"])
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_no_round_consumes_unfinished_telemetry(depth, policy):
    """Every telemetry row the placement model receives belongs to a round
    that had passed its device sync when the row was delivered."""
    eng = _engine(depth, telemetry_mode="measured", barrier_policy=policy)
    finished, delivered = set(), []
    orig_post = eng._post_execute
    orig_observe = eng.placement.observe_type

    def spy_post(prep, metrics):
        float(metrics.loss)            # device sync: round t is now done
        finished.add(prep.t)
        orig_post(prep, metrics)

    def spy_observe(round_idx, type_name, x, t):
        delivered.append((round_idx, round_idx in set(finished)))
        return orig_observe(round_idx, type_name, x, t)

    eng._post_execute = spy_post
    eng.placement.observe_type = spy_observe
    res = eng.run(8)
    assert delivered, "measured mode delivered no telemetry"
    assert not [r for r, ok in delivered if not ok]
    assert eng.control.audit() == []
    assert eng.placement.ready_for(eng.pool.snapshot())
    st = eng.control_stats["barrier"]
    assert st["rows_attributed"] > 0 and st["rows_exact"] == 0
    if depth <= 1:
        assert all(r.barrier_stall_s == 0.0 for r in res)


def test_stall_policy_only_stalls_beyond_depth_one():
    def slow(eng):
        orig = eng._execute

        def run(prep):
            time.sleep(0.15)
            return orig(prep)

        eng._execute = run
        return eng

    for depth in (0, 1):
        eng = slow(_engine(depth, telemetry_mode="measured",
                           barrier_policy="stall"))
        eng.run(6)
        assert eng.control.measured.stalls == 0, depth
    eng = slow(_engine(2, telemetry_mode="measured", barrier_policy="stall"))
    res = eng.run(6)
    assert eng.control.measured.stats()["stalls"] > 0
    assert sum(r.barrier_stall_s for r in res) > 0
    assert eng.control.audit() == []


def test_measured_mode_draws_no_synthetic_telemetry_and_split_runs_stay_armed():
    eng = _engine(2, telemetry_mode="measured", barrier_policy="stall")
    before = repr(eng.telemetry.rng.bit_generator.state)
    eng.run(3)
    eng.run(3)
    assert repr(eng.telemetry.rng.bit_generator.state) == before
    assert eng.control.audit() == [] and len(eng.history) == 6


def test_measured_mesh_records_exact_worker_times():
    """The mesh path syncs every worker program on its own: worker times
    are exact, the predicted-share attribution is unused, and each live
    worker has a residual."""
    eng = _engine(1, telemetry_mode="measured", workers=4, mesh_workers=2,
                  combine_mode="tree", combine_compress="int8")
    eng.run(4)
    st = eng.control_stats
    assert st["barrier"]["rows_attributed"] == 0
    assert st["barrier"]["rows_exact"] > 0
    assert st["audit_violations"] == 0
    assert set(st["worker_residuals"]) == {0, 1, 2, 3}
    assert st["combine_compress"]["rounds"] == 4


def test_restore_and_abort_leave_audit_clean():
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(1, telemetry_mode="measured", barrier_policy="stall",
                      rounds_per_ckpt=2, ckpt=d)
        eng.run(5)
        assert eng.restore_latest() and eng.round_idx == 4
        eng.run(3)
        assert eng.control.audit() == []
    mt = MeasuredTelemetry(policy="stall", stall_timeout_s=30.0)
    mt.begin_run(0)
    th = threading.Thread(target=lambda: mt.flush(5))
    th.start()
    time.sleep(0.05)
    mt.abort()
    th.join(timeout=10)
    assert not th.is_alive() and audit_violations(mt) == []


@pytest.mark.parametrize("mode", list(CONTROL_MODES))
def test_synthetic_control_bit_identical_across_depths(mode):
    """The controller idle, adapting or in fallback acts producer-side in
    round order: losses and the simulated schedule are bit-identical at
    depths 0/1/2 (and, idle, equal to a controller-off run)."""
    runs = {}
    for depth in (0, 1, 2):
        eng = _engine(depth, **CONTROL_MODES[mode])
        runs[depth] = [(r.loss, r.makespan, r.idle_time, r.drift_fallback)
                       for r in eng.run(8)]
        if mode == "adapting":
            assert eng.control.autoconc.updates > 0
    assert runs[0] == runs[1] == runs[2]
    if mode == "idle":
        assert runs[0] == [(r.loss, r.makespan, r.idle_time, False)
                           for r in _engine(0).run(8)]
    if mode == "fallback":
        assert any(f for *_, f in runs[0])


def test_device_failure_wakes_stalled_producer_quickly():
    eng = _engine(2, telemetry_mode="measured", barrier_policy="stall")
    eng.control.measured.stall_timeout_s = 60.0
    eng.run(2)
    orig = eng._execute

    def boom(prep):
        if prep.t >= 4:
            time.sleep(0.3)   # let the prep two rounds ahead reach the stall
            raise RuntimeError("device died")
        return orig(prep)

    eng._execute = boom
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="device died"):
        eng.run(6)
    assert time.perf_counter() - t0 < 30.0
    assert len(eng.history) == 4


def test_engine_applies_slot_updates_to_pool():
    eng = _engine(1, adapt_interval=2)
    before = {w.wid: w.concurrency for w in eng.pool.snapshot()}
    eng.run(8)
    after = {w.wid: w.concurrency for w in eng.pool.snapshot()}
    assert eng.control.autoconc.updates > 0 and before != after
    slots = eng.control.autoconc.stats()["slots"]["a40"]
    assert all(c == slots for c in after.values())


# -- controller state across checkpoints (tests/test_control.py:523-613) ------
def test_checkpoint_persists_controller_state(tmp_path):
    def engine():
        return _engine(1, drift_threshold=0.01, adapt_interval=2,
                       rounds_per_ckpt=2, ckpt=tmp_path)

    a = engine()
    a.run(6)
    saved = a._control_ckpt_state
    assert saved["drift"]["states"]["a40"][1] > 0
    b = engine()
    assert b.restore_latest() and b.round_idx == 6
    assert b.control.state_dict() == saved
    st = b.control.drift.states["a40"]
    assert st.n > 0 and st.ewma > 0.0
    assert b.control.autoconc.trajectory == a.control.autoconc.trajectory[
        :len(b.control.autoconc.trajectory)]
    b.run(1)


def test_checkpoint_without_controller_snapshot_falls_back_to_reset(tmp_path):
    _engine(1, rounds_per_ckpt=2, ckpt=tmp_path).run(4)
    b = _engine(1, drift_threshold=0.01, rounds_per_ckpt=2, ckpt=tmp_path)
    assert b.restore_latest() and b.round_idx == 4
    assert not b.control.drift.drifted
    b.run(1)


def test_drift_detector_resumes_mid_hysteresis():
    def feed_recovery(d):
        d.update(3, "a40", [0.3] * 4)
        held = d.drifted
        d.update(4, "a40", [0.05] * 12)
        return held, d.drifted, [e[2] for e in d.events]

    live = DriftDetector(threshold=0.5, window=4, recover_fraction=0.5,
                         min_points=4)
    live.update(1, "a40", [0.1] * 4)
    live.update(2, "a40", [2.0] * 6)
    assert live.drifted
    resumed = DriftDetector(threshold=0.5, window=4, recover_fraction=0.5,
                            min_points=4)
    resumed.load_state(live.state_dict())
    assert resumed.drifted and resumed.states["a40"].since_round == 2
    assert feed_recovery(resumed) == feed_recovery(live)
    assert [e[2] for e in resumed.events] == ["drift", "recover"]


def test_measured_pending_rows_roundtrip_drops_future_rounds():
    mt = MeasuredTelemetry(policy="reuse")
    mt.begin_run(0)
    mt.record(3, 1.0, [("a40", 4.0, 1.0)], n_steps=4)
    mt.record(5, 2.0, [("a40", 8.0, 1.0)], n_steps=8)
    fresh = MeasuredTelemetry(policy="reuse")
    fresh.load_state(mt.state_dict(), 5)
    assert fresh.last_finished == 4
    assert {m[0] for m in fresh._pending_meta} == {3}
    assert fresh.audit == []
    fr = fresh.flush(6)
    assert fr.rows and all(r[0] == 3 for r in fr.rows)


def test_autoconc_state_roundtrip_preserves_climb():
    ac = AdaptiveConcurrency(interval=1, min_slots=1, max_slots=16)
    ac.seed("a40", 2)
    for _ in range(5):
        ac.observe_round(100.0 - (ac.states["a40"].slots - 6) ** 2)
        ac.maybe_update(0)
    fresh = AdaptiveConcurrency(interval=1, min_slots=1, max_slots=16)
    fresh.load_state(ac.state_dict())
    assert vars(fresh.states["a40"]) == vars(ac.states["a40"])
    assert fresh._window == ac._window and fresh.trajectory == ac.trajectory
    for c in (ac, fresh):
        c.observe_round(95.0)
        c.maybe_update(1)
    assert fresh.states["a40"].slots == ac.states["a40"].slots


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_control_state_restores_across_packages(tmp_path, writer):
    """A checkpoint written with the control plane live, by either
    package, restores into the other: the same controller state, and the
    resumed round makes the same assignment and fallback decision as the
    uninterrupted run of the writer."""
    kw = dict(drift_threshold=0.01, adapt_interval=2)
    src = par.system_engine(writer == "port", ckpt=tmp_path, **kw)
    whole = src.run(4)                     # checkpoints at rounds 2 and 4
    saved = src._control_ckpt_state        # what the round-4 file holds
    src_log = _spy_assignments(src)
    whole += src.run(1)
    dst = par.system_engine(writer != "port", ckpt=tmp_path, **kw)
    assert dst.restore_latest() and dst.round_idx == 4
    assert dst.control.state_dict() == saved
    log = _spy_assignments(dst)
    res = dst.run(1)
    assert log == src_log
    assert res[0].drift_fallback == whole[4].drift_fallback
    assert res[0].makespan == whole[4].makespan
    np.testing.assert_allclose(res[0].loss, whole[4].loss, rtol=SR_LOSS_RTOL)


# -- config validation ---------------------------------------------------------
def test_engine_config_validates_control_knobs():
    with pytest.raises(ValueError, match="telemetry_mode"):
        EngineConfig(telemetry_mode="wallclock")
    with pytest.raises(ValueError, match="barrier_policy"):
        EngineConfig(barrier_policy="block")
    with pytest.raises(ValueError, match="drift_threshold"):
        EngineConfig(drift_threshold=-0.1)
    with pytest.raises(ValueError, match="adapt_interval"):
        EngineConfig(adapt_interval=-1)
    with pytest.raises(ValueError, match="adapt_granularity"):
        EngineConfig(adapt_granularity="gpu")
    with pytest.raises(ValueError, match="device_cache_bytes"):
        EngineConfig(device_cache_bytes=-8)
    with pytest.raises(ValueError, match="requires telemetry_mode"):
        EngineConfig(barrier_policy="stall")
    assert not EngineConfig().control_enabled
    assert EngineConfig(telemetry_mode="measured").control_enabled
    assert EngineConfig(drift_threshold=0.5).control_enabled
    assert EngineConfig(adapt_interval=3).control_enabled
    assert _engine(1).control is None and _engine(1).control_stats == {}
    ctl = tctl.ControlPlane(
        tctl.ControllerConfig(telemetry_mode="measured", drift_threshold=0.5,
                              adapt_interval=2),
        placement=make_placement("lb"))
    assert ctl.measured is not None and ctl.drift is not None
    assert ctl.autoconc is not None
