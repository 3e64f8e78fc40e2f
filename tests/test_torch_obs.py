"""The port's observability exporters against the JAX reference, and the
reference's observability invariants inside the port.

* The Perfetto export (``obs/perfetto.py``) writes the reference's JSON
  document for the same span records.
* The flight recorder (``obs/flight.py``) keeps a bounded window, never
  raises from ``dump``, and dumps on a prep failure, a device failure and
  a failed synchronous round (``tests/test_obs.py:241-260`` on the port).
* Tracing never perturbs training: losses, the schedule and the SLO fields
  are bit-identical with the tracer on or off, at depths 0/1/2, fused and
  mesh, with the controller live.
* The CLI's ``--trace-out`` / ``--trace-rounds`` / ``--flight-rounds``.
"""

import json
import signal
import threading

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_parity as par  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401
from repro import obs as jobs  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402


def _engine(mesh=0, depth=1, obs=None, **cfg):
    """``tests/test_obs.py``'s engine on the port: 4 workers x 2 lanes."""
    if mesh:
        cfg["mesh_workers"] = mesh
    return par.system_engine(True, depth=depth, workers=4, obs=obs, **cfg)


def _signature(results):
    return [(r.loss, r.makespan, r.idle_time, r.slo_p50, r.slo_p99,
             r.n_clients, r.drift_fallback) for r in results]


# -- Perfetto export -------------------------------------------------------------
def _records():
    """One span of every kind, as a tracer snapshot holds them."""
    tr = jobs.Tracer()
    with tr.span("prep.pack", t=0):
        pass
    tr.instant("ctl.slots", round=0, detail="a40: 2 -> 3")
    tr.counter("online_pool", 912.5)
    tr.add_span("exec.sync", 10.0, 0.25, lane="worker1", wid=1)
    tr.add_span("exec.host_merge", 10.5, 0.125, lane="host0", host=0)
    return tr.snapshot()


def test_perfetto_document_matches_the_reference(tmp_path):
    recs = _records()
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    assert jobs.write_trace(jpath, recs) == jpath
    assert tobs.write_trace(tpath, recs) == tpath
    jdoc, tdoc = json.load(open(jpath)), json.load(open(tpath))
    assert tdoc == jdoc
    assert tobs.trace_events([]) == jobs.trace_events([])
    evs = tdoc["traceEvents"]
    assert {e["ph"] for e in evs} == {"M", "X", "i", "C"}
    sync = next(e for e in evs if e.get("name") == "exec.sync")
    assert sync["dur"] == pytest.approx(0.25e6)


def test_port_tracer_records_export_like_the_reference(tmp_path):
    """The port's own tracer snapshot of a traced engine run exports to the
    reference's schema: one process, a lane per thread and worker."""
    obs = tobs.make_observability(trace_rounds=8)
    _engine(mesh=2, obs=obs, drift_threshold=0.01).run(5)
    recs = obs.tracer.snapshot()
    tdoc = tobs.trace_events(recs)
    assert tdoc == jobs.trace_events(recs)
    lanes = {e["args"]["name"] for e in tdoc if e["name"] == "thread_name"}
    assert {"worker0", "worker1", "worker2", "worker3"} <= lanes
    names = {e["name"] for e in tdoc if e["ph"] == "X"}
    assert {"prep.barrier", "prep.pack", "exec.sync", "exec.combine",
            "exec.wait"} <= names
    assert any(e["name"] == "ctl.drift_fallback" for e in tdoc
               if e["ph"] == "i")


# -- tracing leaves results alone -------------------------------------------------
@pytest.mark.parametrize("mesh", [0, 2])
def test_tracer_on_off_bit_identity_matrix(mesh):
    kw = dict(drift_threshold=0.4, adapt_interval=2,
              adapt_granularity="worker")
    for depth in (0, 1, 2):
        base = _signature(_engine(mesh, depth, **kw).run(5))
        obs = tobs.make_observability(trace_rounds=16, flight_rounds=4)
        got = _signature(_engine(mesh, depth, obs=obs, **kw).run(5))
        assert got == base, f"tracer perturbed results at depth {depth}"
        names = {r[1] for r in obs.tracer.snapshot()}
        assert {"prep.pack", "exec.wait"} <= names
        if mesh:
            lanes = {r[4] for r in obs.tracer.snapshot()
                     if r[1] == "exec.sync"}
            assert lanes == {f"worker{w}" for w in range(4)}


def test_traced_engine_produces_producer_lane_spans():
    obs = tobs.make_observability(trace_rounds=16)
    _engine(depth=2, obs=obs).run(4)
    by_lane: dict = {}
    for r in obs.tracer.snapshot():
        if r[0] == "X":
            by_lane.setdefault(r[4], []).append(r[1])
    pack = [ln for ln in by_lane if ln.startswith("pollen-pack")]
    assert pack and by_lane[pack[0]].count("prep.pack") == 3
    main = threading.current_thread().name
    assert by_lane[main].count("prep.pack") == 1
    assert "exec.wait" in by_lane[main]


# -- flight recorder --------------------------------------------------------------
def test_flight_recorder_retention_is_bounded(tmp_path):
    fr = tobs.FlightRecorder(tobs.Tracer(), tobs.MetricsRegistry(), rounds=3,
                             path=str(tmp_path / "flight.json"))
    for i in range(10):
        fr.on_round(i, {"loss": float(i)})
    assert fr.dump("unit test") is not None
    doc = json.load(open(fr.path))
    assert [r["round"] for r in doc["rounds"]] == [7, 8, 9]
    assert doc["reason"] == "unit test"
    assert fr.dumps == 1 and fr.last_reason == "unit test"


def test_flight_recorder_dump_never_raises(tmp_path):
    fr = tobs.FlightRecorder(tobs.Tracer(),
                             path=str(tmp_path / "no" / "\0bad"))
    assert fr.dump("boom") is None
    assert fr.dumps == 0


@pytest.mark.parametrize("where", ["prep", "device", "sync_round"])
def test_flight_recorder_dumps_on_an_abort(tmp_path, where):
    """A prep failure and a device failure abort the pipeline, a failed
    round aborts ``run_round`` (depth 0): each dumps the retained rounds,
    the span window and the metrics, naming the error."""
    path = str(tmp_path / "flight.json")
    obs = tobs.make_observability(trace_rounds=16, flight_rounds=4,
                                  flight_path=path)
    eng = _engine(depth=0 if where == "sync_round" else 1, obs=obs,
                  telemetry_mode="measured")
    eng.run(3)

    def boom(*_):
        raise RuntimeError(f"injected {where} failure")

    if where == "prep":
        eng.placement.refit = boom
    else:
        eng._execute = boom
    with pytest.raises(RuntimeError, match=f"injected {where} failure"):
        eng.run(2)
    doc = json.load(open(path))
    kind = "run_round abort" if where == "sync_round" else "pipeline abort"
    assert kind in doc["reason"] and f"injected {where}" in doc["reason"]
    assert doc["rounds"][-1]["round"] == 2 and "critique" in doc["rounds"][-1]
    assert doc["spans"] and doc["metrics"]["counters"]["rounds"] == 3
    assert eng.control.audit() == []


# -- the CLI ----------------------------------------------------------------------
def test_cli_trace_out_and_flight_rounds(tmp_path, monkeypatch):
    monkeypatch.setattr(ttrain, "set_deterministic", lambda: None)
    monkeypatch.setattr(ttrain, "resolve_device",
                        lambda d: torch.device("cpu"))
    before = signal.getsignal(signal.SIGTERM)
    trace, out = tmp_path / "trace.json", tmp_path / "m.json"
    try:
        assert ttrain.main([
            "--task", "sr", "--cohort", "2", "--workers", "1",
            "--concurrency", "1", "--steps-cap", "1", "--population", "64",
            "--rounds", "2", "--telemetry", "measured", "--barrier-policy",
            "stall", "--pipeline-depth", "2", "--trace-out", str(trace),
            "--trace-rounds", "8", "--flight-rounds", "4", "--metrics-out",
            str(out)]) == 0
        assert signal.getsignal(signal.SIGTERM) is not before
    finally:
        signal.signal(signal.SIGTERM, before)
    doc = json.load(open(trace))
    assert any(e.get("name") == "exec.wait" for e in doc["traceEvents"])
    summary = json.loads(out.read_text())["summary"]
    assert summary["tracer"]["spans"] > 0
    assert summary["control"]["audit_violations"] == 0
    assert summary["control"]["barrier"]["policy"] == "stall"
    assert summary["barrier_stall_s"] >= 0.0
