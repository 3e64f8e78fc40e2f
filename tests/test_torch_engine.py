"""The port's host side and engine against the JAX reference.

* The numpy modules the port copies (sampling, telemetry, time model,
  placement, packing, elastic pool, dataset tables) give bitwise-equal
  draws, fits, assignments and plans.
* Over 3 end-to-end rounds, with the reference's dataset and weights given
  to both engines, sampling, placement, makespan and idle are bitwise equal
  and the losses agree to rtol 1e-5 (GEMM summation order differs).
* The port's own losses are bit-identical across pipeline depths 0/1/2.
* The port never loads JAX, and never runs on the CPU unless asked.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_parity as par  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401
from repro.core import placement as jplace  # noqa: E402
from repro.core import sampling as jsamp  # noqa: E402
from repro.core import telemetry as jtel  # noqa: E402
from repro.core import timemodel as jtm  # noqa: E402
from repro.data import batching as jbat  # noqa: E402
from repro.data import federated as jfed  # noqa: E402
from repro.distributed import elastic as jel  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import placement as tplace  # noqa: E402
from repro_torch.core import sampling as tsamp  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.core import timemodel as ttm  # noqa: E402
from repro_torch.data import batching as tbat  # noqa: E402
from repro_torch.data import federated as tfed  # noqa: E402
from repro_torch.distributed import elastic as tel  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Fields of RoundResult that come from host-side simulation only.
HOST_FIELDS = ("round_idx", "n_clients", "makespan", "idle_time",
               "useful_fraction", "placement", "s_steps", "slo_p50",
               "slo_p99", "idle_fraction")


# -- the copied host modules ------------------------------------------------
@pytest.mark.parametrize("kind", ["uniform", "zipf", "poc"])
def test_sampler_draws_and_state_match(kind):
    def make(mod):
        if kind == "zipf":
            return mod.ZipfSampler(500, 16, a=1.3, seed=3)
        if kind == "poc":
            return mod.PowerOfChoiceSampler(500, 16, seed=3)
        return mod.UniformSampler(500, 16, seed=3)

    j, t = make(jsamp), make(tsamp)
    for r in range(5):
        np.testing.assert_array_equal(t.sample(r), j.sample(r))
    assert tsamp.sampler_state(t) == jsamp.sampler_state(j)
    back = tsamp.restore_sampler(jsamp.sampler_state(j))
    np.testing.assert_array_equal(back.sample(5), j.sample(5))


def test_telemetry_draws_and_time_model_fits_match():
    j, t = jtel.SyntheticTelemetry(seed=11), ttel.SyntheticTelemetry(seed=11)
    xs = np.arange(1, 41)
    for tname in ("a40", "2080ti"):
        jt_ = j.sample_times(tname, xs, concurrency=2)
        np.testing.assert_array_equal(
            t.sample_times(tname, xs, concurrency=2), jt_)
        jf, tf = jtm.fit_log_linear(xs, jt_), ttm.fit_log_linear(xs, jt_)
        assert (tf.a, tf.b, tf.c, tf.d) == (jf.a, jf.b, jf.c, jf.d)
    jm, tm = jtm.TrainingTimeModel(), ttm.TrainingTimeModel()
    for r in range(6):
        for x in (3, 7, 12):
            tt = float(j.sample_time("a40", x))
            jm.observe(r, x, tt)
            tm.observe(r, x, tt)
    jm.refit(6)
    tm.refit(6)
    np.testing.assert_array_equal(tm.predict(xs.astype(float)),
                                  jm.predict(xs.astype(float)))


@pytest.mark.parametrize("name", ["rr", "bb", "lb"])
def test_placement_assignments_match(name):
    ds = par.small_dataset()
    specs = [("a40", 1.0, 2), ("2080ti", 0.42, 2)]
    jpool, tpool = jel.WorkerPool.from_specs(specs), tel.WorkerPool.from_specs(specs)
    jp, tp = jplace.make_placement(name), tplace.make_placement(name)
    jtel_, ttel_ = jtel.SyntheticTelemetry(seed=5), ttel.SyntheticTelemetry(seed=5)
    rng = np.random.default_rng(0)
    for r in range(5):
        cids = rng.choice(64, 8, replace=False)
        jc = [jplace.ClientInfo(int(c), ds.n_batches(c), ds.n_samples(c))
              for c in cids]
        tc = [tplace.ClientInfo(int(c), ds.n_batches(c), ds.n_samples(c))
              for c in cids]
        if name == "lb":
            jp.refit(r)
            tp.refit(r)
        ja = jp.assign(jc, jpool.snapshot())
        ta = tp.assign(tc, tpool.snapshot())
        assert {w: [c.cid for c in cs] for w, cs in ta.per_worker.items()} \
            == {w: [c.cid for c in cs] for w, cs in ja.per_worker.items()}
        if name == "lb":
            for w in jpool.snapshot():
                for c in ja.per_worker.get(w.wid, []):
                    t_c = jtel_.sample_time(w.type_name, c.n_batches)
                    assert t_c == ttel_.sample_time(w.type_name, c.n_batches)
                    jp.observe_type(r, w.type_name, c.n_batches, t_c)
                    tp.observe_type(r, w.type_name, c.n_batches, t_c)


def test_packer_plans_and_arrays_match():
    ds = par.small_dataset()
    workers = jel.WorkerPool.homogeneous(2, concurrency=2).snapshot()
    clients = [jplace.ClientInfo(c, ds.n_batches(c), ds.n_samples(c))
               for c in (3, 9, 17, 21, 40)]
    asg = jplace.BatchesBasedPlacement().assign(clients, workers)
    jplan = jbat.plan_round(asg, workers, lanes_per_worker=2, steps_cap=4)
    tplan = tbat.plan_round(asg, workers, lanes_per_worker=2, steps_cap=4)
    for f in ("w_idx", "p_idx", "s_idx", "cids", "batch_idx", "b_w", "b_p",
              "b_s", "b_weight", "b_cid", "b_nb"):
        np.testing.assert_array_equal(getattr(tplan, f), getattr(jplan, f))
    align = teng.s_bucket
    ja = jbat.build_round_arrays(ds, plan=jplan, batch_size=4, s_align=align,
                                 buffers=jbat.PackBuffers(2))
    ta = tbat.build_round_arrays(ds, plan=tplan, batch_size=4, s_align=align,
                                 buffers=tbat.PackBuffers(2))
    for f in ("step_mask", "boundary", "weight"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f))
    for k in ja.batches:
        np.testing.assert_array_equal(ta.batches[k], ja.batches[k])
    assert tbat.padding_stats(ta) == jbat.padding_stats(ja)


def test_dataset_tables_match_and_content_is_deterministic():
    j, t = jfed.make_federated_dataset("sr"), tfed.make_federated_dataset("sr")
    np.testing.assert_array_equal(t.sizes, j.sizes)
    np.testing.assert_array_equal(t._class_logits, j._class_logits)
    assert [t.n_batches(c) for c in range(300)] == \
        [j.n_batches(c) for c in range(300)]
    got = t.gather_batches(np.asarray([5, 5, 7]), np.asarray([0, 1, 0]))
    assert got["x"].shape == (3, 20, 64) and got["x"].dtype == np.float32
    assert got["y"].shape == (3, 20) and got["y"].dtype == np.int32
    assert 0 <= got["y"].min() and got["y"].max() < 35
    one = t.client_batch(5, 1)
    np.testing.assert_array_equal(one["x"], got["x"][1])
    assert not np.array_equal(got["x"][0], got["x"][1])


def test_elastic_pool_and_deadline_trim_match():
    jp, tp = jel.WorkerPool.homogeneous(3), tel.WorkerPool.homogeneous(3)
    for mod, pool in ((jel, jp), (tel, tp)):
        pool.schedule(mod.FailureEvent(round_idx=1, kind="fail", wid=1))
        pool.schedule(mod.FailureEvent(round_idx=2, kind="join", wid=7,
                                       type_name="a40"))
    for r in range(4):
        jp.advance_to(r)
        tp.advance_to(r)
        assert [(w.wid, w.type_name) for w in tp.snapshot()] == \
            [(w.wid, w.type_name) for w in jp.snapshot()]
    clients = [jplace.ClientInfo(c, c % 7 + 1, 4 * (c % 7 + 1))
               for c in range(12)]
    assert [c.cid for c in tel.deadline_trim(clients, 8, lambda x: x)] == \
        [c.cid for c in jel.deadline_trim(clients, 8, lambda x: x)]


# -- the engine -----------------------------------------------------------------
@pytest.mark.parametrize("deadline_rho", [0.0, 0.5])
def test_three_rounds_track_the_reference_engine(deadline_rho):
    """deadline_rho 0.5 over-samples the cohort and trims predicted
    stragglers (the trim uses the LB time model from round 2 on)."""
    ds = par.small_dataset()
    params = par.ref_params()
    jeng = par.ref_engine(ds, params, deadline_rho=deadline_rho)
    teng_ = par.port_engine(ds, par.to_torch(params),
                            deadline_rho=deadline_rho)
    jres, tres = jeng.run(3), teng_.run(3)
    for j, t in zip(jres, tres):
        for f in HOST_FIELDS:
            assert getattr(t, f) == getattr(j, f), f
        np.testing.assert_allclose(t.loss, j.loss, rtol=1e-5)
    assert teng_.sampler.rng.bit_generator.state == \
        jeng.sampler.rng.bit_generator.state
    assert teng_.telemetry.state_dict() == jeng.telemetry.state_dict()
    for k, v in teng_.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jeng.params[k]),
                                   rtol=1e-4, atol=1e-6)


def test_port_losses_bit_identical_across_depths():
    ds = tfed.make_federated_dataset("sr", n_clients=64, batch_size=4,
                                     size_mu=2.5, size_sigma=0.8)
    params = par.to_torch(par.ref_params(1))
    runs = {}
    for depth in (0, 1, 2):
        eng = par.port_engine(ds, params, depth=depth)
        runs[depth] = [(r.loss, r.makespan, r.s_steps) for r in eng.run(4)]
    assert runs[0] == runs[1] == runs[2]
    assert all(np.isfinite(loss) for loss, _, _ in runs[0])
    assert runs[0][-1][0] < runs[0][0][0]                 # it trains


def test_engine_params_are_read_only_and_reassignable():
    """``eng.params`` holds views of the flat buffer the rounds read: a leaf
    set into it would be ignored, so that raises; assigning a whole new
    dict replaces the model the next round starts from."""
    ds = par.small_dataset()
    first = par.to_torch(par.ref_params(1))
    second = par.to_torch(par.ref_params(2))
    eng = par.port_engine(ds, first)
    name = next(iter(first))
    with pytest.raises(TypeError, match="FlatTree"):
        eng.params[name] = second[name]
    with pytest.raises(TypeError, match="FlatTree"):
        eng.params.update(second)
    eng.params = second
    for k, v in second.items():
        assert torch.equal(eng.params[k], v)
    swapped = [r.loss for r in eng.run(2)]
    assert swapped == [r.loss for r in par.port_engine(ds, second).run(2)]


def test_tracing_leaves_results_bit_identical():
    from repro_torch.obs import make_observability
    ds = par.small_dataset()
    params = par.to_torch(par.ref_params(2))
    obs = make_observability(trace_rounds=4)
    plain = [r.loss for r in par.port_engine(ds, params).run(3)]
    traced = [r.loss for r in par.port_engine(ds, params, obs=obs).run(3)]
    assert traced == plain
    names = {rec[1] for rec in obs.tracer.snapshot()}
    assert {"prep.pack", "prep.h2d", "exec.dispatch", "exec.wait",
            "compile"} <= names
    assert obs.metrics.snapshot()["counters"]["rounds"] == 3


def test_build_engine_runs_published_sr_on_cpu_when_asked():
    eng = ttrain.build_engine(task="sr", cohort=4, steps_cap=2,
                              device="cpu")
    assert sum(v.numel() for v in eng.params.values()) == 4_244_992
    res = eng.run(1)
    assert np.isfinite(res[0].loss) and res[0].n_clients == 4
    assert eng.compile_stats["compiles"] == 1


def test_build_engine_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.build_engine()


@pytest.mark.parametrize("field,value", [
    ("device_cache_batches", 8), ("device_cache_bytes", 1 << 20),
    ("cache_affinity", True), ("telemetry_mode", "measured"),
    ("barrier_policy", "stall"), ("drift_threshold", 0.5),
    ("adapt_interval", 2), ("adapt_granularity", "worker")])
def test_unported_engine_options_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP M1"):
        teng.EngineConfig(**{field: value})


@pytest.mark.parametrize("argv", [["--population-surge", "2:4"],
                                  ["--flight-rounds", "4"],
                                  ["--sampler", "online"],
                                  ["--trace-out", "t.json"],
                                  ["--device-cache-batches", "8"]])
def test_unported_cli_flags_raise_before_touching_the_device(argv, monkeypatch):
    monkeypatch.setattr(ttrain, "set_deterministic", lambda: None)
    monkeypatch.setattr(ttrain, "resolve_device", lambda d: torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="M"):
        ttrain.main(argv)


def test_port_imports_no_jax():
    code = ("import sys, pkgutil, importlib, repro_torch\n"
            "import repro_torch.launch.train\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n"
            "raise SystemExit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
