"""The port's open-world population against the JAX reference, and the
reference's population invariants inside the port.

* The copied numpy modules (``population/*``) give equal store
  attributes, arrival rates and online masks, ``OnlinePoolSampler`` draws
  and stats; every sampler kind's checkpoint state round-trips, and each
  package restores the other's.
* ``--sampler online`` at a population of 100,000: the port's engine draws
  the reference's cohorts and reports its SLO fields (``slo_p50``,
  ``slo_p99``, ``stale_fraction``, ``online_pool``) exactly; losses agree
  to rtol 1e-5 (the SR system parity tolerance).
* Inside the port: SLO fields and losses identical across depths 0/1/2
  with the controller live, a million-client round costs O(cohort), and a
  resumed run replays the online stream (``tests/test_population.py``).
"""

import json
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_parity as par  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401
from repro import population as jpop  # noqa: E402
from repro.core import sampling as jsamp  # noqa: E402
from repro.data import make_federated_dataset  # noqa: E402
from repro_torch import population as tpop  # noqa: E402
from repro_torch.core import sampling as tsamp  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

SR_LOSS_RTOL = 1e-5
SLO = ("slo_p50", "slo_p99", "stale_fraction", "online_pool")


def _index(mod, population=10_000, seed=17, **kw):
    store = mod.ClientMetadataStore(population, seed=seed, batch_size=4)
    return mod.ArrivalIndex(store, **kw)


# -- the copied modules, against the reference ----------------------------------
def test_store_attributes_match_the_reference():
    cids = np.concatenate([np.arange(0, 10_000, 7),
                           np.asarray([999_999, 123_456_789])])
    for kw in ({}, dict(size_mu=3.0, size_sigma=0.5, size_max=1_000)):
        j = jpop.ClientMetadataStore(1_000_000_000, seed=3, batch_size=20,
                                     **kw)
        t = tpop.ClientMetadataStore(1_000_000_000, seed=3, batch_size=20,
                                     **kw)
        for attr in ("phase", "region_idx", "n_samples", "n_batches"):
            np.testing.assert_array_equal(getattr(t, attr)(cids),
                                          getattr(j, attr)(cids))
        assert t.region(5) == j.region(5)
        assert t.state_dict() == j.state_dict()
        clone = tpop.ClientMetadataStore.from_state(
            json.loads(json.dumps(j.state_dict())))
        np.testing.assert_array_equal(clone.phase(cids), j.phase(cids))
    assert tpop.splitmix64(np.arange(9, dtype=np.uint64)).tolist() == \
        jpop.splitmix64(np.arange(9, dtype=np.uint64)).tolist()


def test_arrival_index_matches_the_reference():
    storms = (dict(kind="surge", start=2, end=9, scale=1.3, region="emea"),
              dict(kind="outage", start=5, end=7, scale=0.0, region=None))
    j = _index(jpop, interventions=tuple(jpop.Intervention(**s)
                                         for s in storms), period=24.0)
    t = _index(tpop, interventions=tuple(tpop.Intervention(**s)
                                         for s in storms), period=24.0)
    cids = np.arange(0, 10_000, 3)
    for rnd in range(0, 30, 2):
        np.testing.assert_array_equal(t.online(cids, rnd), j.online(cids, rnd))
        assert t.expected_online(rnd) == j.expected_online(rnd)
        for region in j.store.region_names:
            assert t.online_fraction(region, rnd) == \
                j.online_fraction(region, rnd)
    assert t.probes == j.probes
    assert t.state_dict() == j.state_dict()


@pytest.mark.parametrize("population,cohort", [(10_000, 16), (100, 64),
                                               (40, 64)])
def test_online_sampler_draws_and_stats_match_the_reference(population,
                                                            cohort):
    """An outage window drafts stale clients; a cohort above the
    population wraps; every draw, stat and probe count is the
    reference's."""
    def make(mod):
        idx = _index(mod, population=population, interventions=(
            mod.Intervention("outage", 3, 6, 0.0),))
        return mod.OnlinePoolSampler(idx, cohort, seed=5)

    j, t = make(jpop), make(tpop)
    for rnd in range(8):
        np.testing.assert_array_equal(t.sample(rnd), j.sample(rnd))
        assert t.last_stats == j.last_stats
    assert t.index.probes == j.index.probes
    assert t.rng.bit_generator.state == j.rng.bit_generator.state


def test_every_sampler_kind_state_round_trips_across_packages():
    """uniform / zipf / poc / online: a JSON'd state of either package
    restores, in both, a sampler whose next draws are the original's."""
    def online(mod):
        return mod.OnlinePoolSampler(_index(mod, interventions=(
            mod.Intervention("surge", 2, 9, 1.3, region="emea"),)), 16,
            seed=17)

    makers = (lambda m: m.UniformSampler(500, 8, seed=5),
              lambda m: m.ZipfSampler(500, 8, a=1.4, seed=5),
              lambda m: m.PowerOfChoiceSampler(500, 8, seed=5))
    for make in makers + (None,):
        states = {}
        for src_mod, src_pop in ((jsamp, jpop), (tsamp, tpop)):
            s = online(src_pop) if make is None else make(src_mod)
            s.sample(0)
            state = json.loads(json.dumps(src_mod.sampler_state(s)))
            states[src_mod] = state
            want = [s.sample(r) for r in range(1, 4)]
            for dst_mod in (jsamp, tsamp):
                r = dst_mod.restore_sampler(state)
                for rnd, w in zip(range(1, 4), want):
                    np.testing.assert_array_equal(r.sample(rnd), w)
        assert states[tsamp] == states[jsamp]
    st = tsamp.sampler_state(online(tpop))
    assert st["kind"] == "online"
    assert st["index"]["interventions"][0]["region"] == "emea"


def test_population_dataset_grafts_sizes_not_content():
    base = make_federated_dataset("sr", n_clients=64, input_dim=8,
                                  batch_size=2)
    store = tpop.ClientMetadataStore(1_000_000, seed=2, batch_size=2)
    ds = tpop.PopulationDataset(base, store)
    assert ds.n_clients == 1_000_000
    assert ds.n_samples(999_999) == int(store.n_samples(999_999))
    a, b = ds.client_batch(123_456, 0), base.client_batch(123_456, 0)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="batch_size"):
        tpop.PopulationDataset(base, tpop.ClientMetadataStore(100,
                                                              batch_size=4))


# -- the engine ------------------------------------------------------------------
def _online_engine(port: bool, *, population=100_000, cohort=8, seed=11,
                   outage=None, **kw):
    """The system-test engine (2 workers x 2 lanes) over an open-world
    population of ``population`` clients on the reference's 256-client SR
    dataset, cohorts from ``OnlinePoolSampler``."""
    mod = tpop if port else jpop
    base = make_federated_dataset("sr", n_clients=256, input_dim=16,
                                  batch_size=4)
    store = mod.ClientMetadataStore(population, seed=seed, batch_size=4)
    ivs = (mod.Intervention("outage", *outage, 0.0),) if outage else ()
    sampler = mod.OnlinePoolSampler(
        mod.ArrivalIndex(store, interventions=ivs), cohort, seed=seed)
    return par.system_engine(port, dataset=mod.PopulationDataset(base, store),
                             sampler=sampler, **kw)


def _spy_cohorts(eng) -> list:
    log = []
    orig = eng.sampler.sample

    def sample(t):
        ids = orig(t)
        log.append(ids.tolist())
        return ids

    eng.sampler.sample = sample
    return log


@pytest.mark.parametrize("control", [{}, {"drift_threshold": 0.6}])
def test_online_engine_matches_the_reference(control):
    """Cohorts, the SLO fields and the schedule equal the reference's at a
    population of 100,000 (an outage window drafts stale clients)."""
    jeng = _online_engine(False, outage=(2, 4), **control)
    teng = _online_engine(True, outage=(2, 4), **control)
    jlog, tlog = _spy_cohorts(jeng), _spy_cohorts(teng)
    jres, tres = jeng.run(5), teng.run(5)
    assert tlog == jlog and len(tlog) == 5
    for j, t in zip(jres, tres):
        for f in SLO + ("makespan", "idle_time", "n_clients",
                        "drift_fallback"):
            assert getattr(t, f) == getattr(j, f), f
        np.testing.assert_allclose(t.loss, j.loss, rtol=SR_LOSS_RTOL)
    # a global outage over rounds [2, 4): nobody online, the cohort stale
    assert [r.stale_fraction for r in tres[2:4]] == [1.0, 1.0]
    assert [r.online_pool for r in tres[2:4]] == [0.0, 0.0]
    assert all(r.online_pool > 0 and r.stale_fraction < 1.0
               for r in tres[:2] + tres[4:])
    assert teng.control_stats == jeng.control_stats


def test_open_world_losses_bit_identical_across_depths_with_controller():
    results = {d: _online_engine(True, depth=d, drift_threshold=0.6,
                                 outage=(1, 3)).run(4)
               for d in (0, 1, 2)}
    losses = {d: [r.loss for r in rs] for d, rs in results.items()}
    assert losses[0] == losses[1] == losses[2], losses
    for r0, r1, r2 in zip(*results.values()):
        assert r0.slo_p99 >= r0.slo_p50 > 0.0
        assert 0.0 <= r0.stale_fraction <= 1.0
        assert (r0.online_pool > 0.0) == (r0.round_idx not in (1, 2))
        assert [getattr(r0, f) for f in SLO] == \
            [getattr(r1, f) for f in SLO] == [getattr(r2, f) for f in SLO]
    assert results[0][1].stale_fraction > 0


def test_million_client_round_is_o_cohort():
    base = make_federated_dataset("sr", n_clients=256, input_dim=16,
                                  batch_size=4)

    def stack_peak_kb(population):
        tracemalloc.start()
        store = tpop.ClientMetadataStore(population, seed=11, batch_size=4)
        sampler = tpop.OnlinePoolSampler(tpop.ArrivalIndex(store), 64,
                                         seed=11)
        ds = tpop.PopulationDataset(base, store)
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        return peak / 1024, sampler, ds

    small, _, _ = stack_peak_kb(10_000)
    big, sampler, ds = stack_peak_kb(1_000_000)
    assert big < 64 and big <= small * 8 + 8, (small, big)
    eng = par.system_engine(True, dataset=ds, sampler=sampler, depth=0,
                            workers=3)
    res = eng.run(2)
    assert all(r.n_clients == 64 for r in res)
    assert sampler.index.probes <= 2 * sampler.max_draw_factor * 64


def test_checkpoint_resume_replays_online_stream(tmp_path):
    """The checkpointed sampler state (store config, traces, RNG position)
    overrides the restoring engine's sampler: round 4 is bit-identical."""
    whole = _online_engine(True, population=4_096, ckpt=tmp_path).run(5)
    b = _online_engine(True, population=4_096, ckpt=tmp_path)
    b.sampler = tpop.OnlinePoolSampler(
        tpop.ArrivalIndex(tpop.ClientMetadataStore(4_096, seed=999,
                                                   batch_size=4)),
        8, seed=999)
    assert b.restore_latest() and b.round_idx == 4
    assert isinstance(b.sampler, tpop.OnlinePoolSampler)
    assert b.sampler.seed == 11
    res = b.run(1)
    for f in ("loss", "n_clients") + SLO:
        assert getattr(res[0], f) == getattr(whole[4], f), f


def test_build_engine_and_cli_run_the_online_sampler(monkeypatch, tmp_path,
                                                     capsys):
    """``build_engine(sampler="online")`` registers the population over a
    base of at most 4,096 clients; the CLI's ``--sampler online
    --population-*`` flags run and report the population."""
    eng = ttrain.build_engine(task="sr", sampler="online",
                              population=1_000_000, cohort=4, workers=1,
                              concurrency=1, steps_cap=1,
                              population_outage="0:2:apac", device="cpu")
    assert eng.dataset.n_clients == 1_000_000
    assert eng.dataset.base.n_clients == 4_096
    assert eng.sampler.index.interventions[0].region == "apac"
    res = eng.run(1)
    assert res[0].n_clients == 4 and res[0].online_pool > 0
    monkeypatch.setattr(ttrain, "set_deterministic", lambda: None)
    monkeypatch.setattr(ttrain, "resolve_device",
                        lambda d: torch.device("cpu"))
    out = tmp_path / "m.json"
    assert ttrain.main(["--task", "sr", "--cohort", "2", "--workers", "1",
                        "--concurrency", "1", "--steps-cap", "1",
                        "--rounds", "2", "--sampler", "online",
                        "--population", "100000", "--population-period",
                        "12", "--population-surge", "0:1:2.0",
                        "--population-outage", "1:2", "--metrics-out",
                        str(out)]) == 0
    summary = json.loads(out.read_text())["summary"]
    assert summary["population"]["registered"] == 100_000
    assert summary["population"]["mean_stale_fraction"] > 0
    with pytest.raises(ValueError, match="START:END"):
        ttrain._parse_intervention("surge", "3")
