"""The port's device batch cache (``repro_torch.data.device_cache``) and its
engine seams, on the CPU.

* Every case of ``tests/test_device_cache.py`` and ``tests/test_reclaim.py``
  has a counterpart here, against the port: plan/apply against the host
  packer, LRU and eviction accounting, byte capacity, per-shard pools,
  orphan-shard reclamation, and the engine (bitwise equal losses with the
  cache on and off, hits under Zipf sampling, invalidation on an abort).
* Parity with the reference: one plan sequence through the reference's
  ``DeviceBatchCache`` (JAX on the CPU) and the port's gives identical
  per-round stats and bitwise-equal assembled batches; the port's SR engine
  with the cache tracks the reference's within rtol 1e-5 on losses (the
  tolerance of ``tests/test_torch_engine.py``: GEMM summation order).
* The port's losses are bitwise equal with the cache on and off at
  pipeline depths 0/1/2, fused and mesh.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_parity as par  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401
from repro.core import ZipfSampler as JZipf  # noqa: E402
from repro.data.batching import gather_content_rows as jgather  # noqa: E402
from repro.data.device_cache import DeviceBatchCache as JCache  # noqa: E402
from repro_torch.control.telemetry import MeasuredTelemetry  # noqa: E402
from repro_torch.core import ZipfSampler, s_bucket  # noqa: E402
from repro_torch.core.engine import _probe_row_bytes  # noqa: E402
from repro_torch.core.placement import (Assignment, ClientInfo,  # noqa: E402
                                        WorkerInfo, apply_cache_affinity)
from repro_torch.data import make_federated_dataset  # noqa: E402
from repro_torch.data.batching import (PackBuffers,  # noqa: E402
                                       build_round_arrays,
                                       gather_content_rows, plan_round)
from repro_torch.data.device_cache import DeviceBatchCache  # noqa: E402
from repro_torch.distributed import FailureEvent  # noqa: E402

DEPTHS = (0, 1, 2)


def _ds():
    return make_federated_dataset("sr", n_clients=32, input_dim=8,
                                  batch_size=2, size_mu=2.0, size_sigma=0.5)


def _assignment(ds, cids, workers=2):
    winfos = [WorkerInfo(wid=i) for i in range(workers)]
    per = {w.wid: [] for w in winfos}
    for i, c in enumerate(cids):
        per[winfos[i % workers].wid].append(
            ClientInfo(cid=c, n_batches=ds.n_batches(c),
                       n_samples=ds.n_samples(c)))
    return Assignment(per_worker=per), winfos


def _miss(rows):
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in rows.items()}


def _device_round(ds, cids, cache, t, *, steps_cap=3, buffers=None,
                  with_ref=True, workers=2, shard=0, slot=0):
    """One cache-mediated round: plan → gather compact miss rows → device
    assembly.  Returns (assembled batches, cache plan, reference full
    pack).  The batches ARE the cache's round base, which the next round
    of the same shape overwrites: read them first."""
    assignment, winfos = _assignment(ds, cids, workers)
    plan = plan_round(assignment, winfos, steps_cap=steps_cap)
    S = s_bucket(plan.s_real)
    cplan = cache.plan(plan, S, t, shard=shard, worker_slot=slot)
    rows = gather_content_rows(ds, plan, cplan.content_mask,
                               cplan.n_miss_rows, batch_size=2,
                               buffers=buffers)
    ref = (build_round_arrays(ds, plan=plan, batch_size=2, s_align=s_bucket)
           if with_ref else None)
    out = cache.apply(_miss(rows), cplan)
    return out, cplan, ref


def _assert_matches_ref(out, ref):
    mask = ref.step_mask.astype(bool)
    for name in ref.batches:
        np.testing.assert_array_equal(out[name].numpy()[mask],
                                      ref.batches[name][mask])


# -- plan/apply, LRU (tests/test_device_cache.py) ----------------------------
def test_cache_round_trip_bit_identical_to_host_pack():
    ds = _ds()
    cache = DeviceBatchCache(64)
    out1, cp1, ref1 = _device_round(ds, [1, 2, 3, 4], cache, t=0)
    assert cp1.hit_steps == 0 and cp1.inserted_clients == 4
    _assert_matches_ref(out1, ref1)
    out2, cp2, ref2 = _device_round(ds, [3, 4, 5, 1], cache, t=1)
    assert cp2.hit_clients == 3 and cp2.miss_clients == 1
    assert cp2.hit_steps > 0
    _assert_matches_ref(out2, ref2)


def test_cache_hit_skips_host_gather():
    ds = _ds()
    cache = DeviceBatchCache(64)
    buffers = PackBuffers(depth=2)
    _device_round(ds, [1, 2], cache, t=0, buffers=buffers)
    calls = []
    orig = ds.gather_batches

    def spy(cids, bidx, **kw):
        calls.append(len(np.asarray(cids)))
        return orig(cids, bidx, **kw)

    ds.gather_batches = spy
    _, cp, _ = _device_round(ds, [1, 2], cache, t=1, buffers=buffers,
                             with_ref=False)
    assert cp.miss_steps == 0 and cp.content_mask is not None
    assert not cp.content_mask.any()
    assert calls == []
    assert cp.n_miss_rows == 1
    assert cp.bytes_saved > 0


def test_lru_eviction_accounting():
    ds = _ds()
    nb = {c: min(ds.n_batches(c), 3) for c in range(8)}
    cap = nb[1] + nb[2] + nb[3]
    cache = DeviceBatchCache(cap)
    _device_round(ds, [1, 2, 3], cache, t=0)
    assert cache.rows_used == cap and cache.clients_cached == 3
    _, cp, _ = _device_round(ds, [2, 3, 4], cache, t=1)
    assert cp.hit_clients == 2 and cp.inserted_clients == 1
    assert cp.evicted_clients >= 1
    assert cache.clients_cached == 3
    _, cp, _ = _device_round(ds, [1], cache, t=2)
    assert cp.hit_clients == 0 and cp.miss_clients == 1
    st = cache.stats()
    assert st["insertions"] - st["evictions"] == cache.clients_cached
    assert st["hit_steps"] + st["miss_steps"] > 0
    assert 0.0 < st["hit_rate"] < 1.0
    assert cache.rows_used <= cap


def test_same_round_entries_never_evicted():
    ds = _ds()
    cache = DeviceBatchCache(min(ds.n_batches(1), 3))
    _, cp, _ = _device_round(ds, [1, 2], cache, t=0)
    assert cp.inserted_clients == 1
    _, cp, _ = _device_round(ds, [1, 2], cache, t=1)
    assert cp.hit_clients == 1
    assert cp.inserted_clients == 0
    assert cp.evicted_clients == 0


def test_nb_mismatch_reinsert_frees_old_rows():
    ds = _ds()
    cache = DeviceBatchCache(64)
    _device_round(ds, [1, 2], cache, t=0, steps_cap=3)
    used_before = cache.rows_used
    for t in range(1, 4):
        _, cp, _ = _device_round(ds, [1, 2], cache, t=t,
                                 steps_cap=2 if t % 2 else 3)
        assert cp.hit_clients == 0
        assert cp.inserted_clients == 2
    assert cache.rows_used <= used_before
    st = cache.stats()
    assert st["insertions"] - st["evictions"] == cache.clients_cached


def test_invalidate_clears_entries_and_recovers():
    ds = _ds()
    cache = DeviceBatchCache(64)
    _device_round(ds, [1, 2], cache, t=0)
    assert cache.clients_cached == 2
    cache.invalidate()
    assert cache.clients_cached == 0 and cache.rows_used == 0
    out, cp, ref = _device_round(ds, [1, 2], cache, t=1)
    assert cp.hit_clients == 0 and cp.inserted_clients == 2
    _assert_matches_ref(out, ref)


def test_oversized_client_never_cached():
    ds = _ds()
    cache = DeviceBatchCache(2)
    _, cp, _ = _device_round(ds, [1], cache, t=0, steps_cap=5)
    if min(ds.n_batches(1), 5) > 2:
        assert cp.inserted_clients == 0 and cache.clients_cached == 0


# -- the engine (tests/test_device_cache.py) ---------------------------------
def _engine(depth, cache_rows, *, cache_bytes=0, mesh=0, **cfg):
    """The system-test engine of the port on the CPU (64 SR clients, 8 a
    round from a Zipf draw; 4 workers over 2 shards with ``mesh``), with
    the cache's options."""
    return par.system_engine(
        True, depth=depth, workers=4 if mesh else 2,
        sampler=ZipfSampler(64, 8, a=1.2), mesh_workers=mesh,
        device_cache_batches=cache_rows, device_cache_bytes=cache_bytes,
        **cfg)


def test_engine_cache_bit_identical_and_hits_under_skew():
    plain = _engine(0, 0).run(8)
    for depth in (0, 2):
        eng = _engine(depth, 64)
        res = eng.run(8)
        assert [r.loss for r in res] == [r.loss for r in plain], depth
        assert sum(r.cache_hit_rate for r in res) > 0
        assert sum(r.cache_bytes_saved for r in res) > 0
        assert all(0.0 <= r.cache_hit_rate <= 1.0 for r in res)
        st = eng.cache_stats
        assert st["hit_steps"] > 0 and st["rounds"] == 8
        assert st["bytes_saved"] == sum(r.cache_bytes_saved for r in res)


def test_engine_cache_accounting_under_eviction():
    plain = _engine(0, 0).run(8)
    eng = _engine(1, 12)
    res = eng.run(8)
    assert [r.loss for r in res] == [r.loss for r in plain]
    st = eng.cache_stats
    assert st["evictions"] > 0
    assert st["insertions"] - st["evictions"] == st["clients_cached"]
    assert eng._device_cache.rows_used <= 12


@pytest.mark.parametrize("depth", (0, 2))
def test_prep_failure_invalidates_cache(depth):
    eng = _engine(depth, 64)
    eng.run(2)
    assert eng._device_cache.clients_cached > 0
    orig = eng.dataset.gather_batches

    def boom(cids, bidx, **kw):
        raise RuntimeError("gather died")

    eng.dataset.gather_batches = boom      # fails AFTER cache.plan ran
    with pytest.raises(RuntimeError, match="gather died"):
        eng.run(3)
    assert eng._device_cache.clients_cached == 0
    assert eng._device_cache.rows_used == 0
    eng.dataset.gather_batches = orig
    res = eng.run(2)                       # the retry trains on real bytes
    assert all(np.isfinite(r.loss) for r in res)


def test_engine_without_cache_reports_zeroes():
    res = _engine(1, 0).run(3)
    assert all(r.cache_hit_rate == 0.0 for r in res)
    assert all(r.cache_bytes_saved == 0 for r in res)
    assert _engine(1, 0).cache_stats == {}


def test_capacity_bytes_converts_to_rows_and_tighter_limit_wins():
    cache = DeviceBatchCache(capacity_bytes=1000, row_bytes=96)
    assert cache.capacity == 1000 // 96
    assert DeviceBatchCache(4, capacity_bytes=1000, row_bytes=96).capacity == 4
    assert DeviceBatchCache(64, capacity_bytes=300, row_bytes=96).capacity == 3
    assert DeviceBatchCache(capacity_bytes=10, row_bytes=96).capacity == 1
    with pytest.raises(ValueError, match="positive capacity"):
        DeviceBatchCache(0)
    with pytest.raises(ValueError, match="row_bytes"):
        DeviceBatchCache(capacity_bytes=1000)
    assert DeviceBatchCache(capacity_bytes=1000, row_bytes=96).stats()[
        "capacity_bytes"] == 1000


def test_probe_row_bytes_matches_packed_leaves():
    from repro.core.engine import _probe_row_bytes as jprobe

    ds = _ds()
    got = _probe_row_bytes(ds, batch_size=2)
    batch = ds.gather_batches(np.asarray([0]), np.asarray([0]), batch_size=2)
    want = sum(int(np.prod(v.shape[1:])) * v.dtype.itemsize
               for v in batch.values())
    assert got == want == jprobe(ds, batch_size=2) > 0
    # SR at its published sizes: 20 rows of 64 f32 features and an int32
    # label each, 5,200 bytes a batch row.
    assert _probe_row_bytes(make_federated_dataset("sr"), batch_size=20) \
        == 5200


def test_engine_byte_capacity_equivalent_to_row_capacity():
    row_bytes = _probe_row_bytes(par.system_dataset(), batch_size=4)
    by_rows = _engine(1, 64)
    by_bytes = _engine(1, 0, cache_bytes=64 * row_bytes)
    assert by_bytes._device_cache.capacity == 64
    r1 = by_rows.run(8)
    r2 = by_bytes.run(8)
    assert [r.loss for r in r1] == [r.loss for r in r2]
    assert [r.cache_hit_rate for r in r1] == [r.cache_hit_rate for r in r2]
    s1, s2 = by_rows.cache_stats, by_bytes.cache_stats
    for k in ("hit_steps", "miss_steps", "insertions", "evictions"):
        assert s1[k] == s2[k], k


# -- per-shard pools (tests/test_device_cache.py) ----------------------------
def _shard_round(ds, cids, cache, t, shard, *, slot=0, steps_cap=3):
    return _device_round(ds, cids, cache, t, steps_cap=steps_cap,
                         workers=1, shard=shard, slot=slot)


def test_per_shard_accounting_sums_to_global():
    ds = _ds()
    cache = DeviceBatchCache(64, n_shards=2)
    assert cache.capacity_per_shard == 32
    _shard_round(ds, [1, 2], cache, 0, shard=0)
    _shard_round(ds, [3, 4], cache, 0, shard=1)
    out, cp, ref = _shard_round(ds, [1, 2], cache, 1, shard=0)
    assert cp.hit_clients == 2 and cp.shard == 0
    _assert_matches_ref(out, ref)
    st = cache.stats()
    assert st["n_shards"] == 2
    for key in ("hit_steps", "miss_steps", "hit_clients", "miss_clients",
                "insertions", "evictions", "bytes_saved", "rounds",
                "clients_cached", "rows_used"):
        assert sum(s[key] for s in st["per_shard"]) == st[key], key
    assert st["per_shard"][0]["hit_clients"] == 2
    assert st["per_shard"][1]["hit_clients"] == 0
    assert cache.shard_for_client(1) == 0
    assert cache.shard_for_client(3) == 1
    assert cache.shard_for_client(99) is None


def test_eviction_in_one_shard_never_touches_another():
    ds = _ds()
    nb = {c: min(ds.n_batches(c), 3) for c in range(16)}
    cache = DeviceBatchCache(2 * (nb[1] + nb[2]), n_shards=2)
    _shard_round(ds, [1, 2], cache, 0, shard=0)
    _shard_round(ds, [5, 6], cache, 0, shard=1)
    resident_1 = set(cache._shards[1].entries)
    pool_1 = {k: v.clone() for k, v in cache._shards[1].pools.items()}
    _, cp, _ = _shard_round(ds, [7, 8], cache, 1, shard=0)
    assert cp.evicted_clients > 0 and cp.shard == 0
    assert cache.stats()["per_shard"][0]["evictions"] > 0
    assert set(cache._shards[1].entries) == resident_1
    assert cache.stats()["per_shard"][1]["evictions"] == 0
    for k, v in cache._shards[1].pools.items():
        assert torch.equal(v, pool_1[k]), k   # not a byte of shard 1 moved
    _, cp1, _ = _shard_round(ds, [5, 6], cache, 2, shard=1)
    assert cp1.hit_clients == 2


def test_worker_slot_keys_isolate_round_bases():
    ds = _ds()
    cache = DeviceBatchCache(64, n_shards=1)
    out_a, _, ref_a = _shard_round(ds, [1, 2], cache, 0, shard=0, slot=0)
    out_b, _, ref_b = _shard_round(ds, [3, 4], cache, 0, shard=0, slot=1)
    _assert_matches_ref(out_a, ref_a)
    _assert_matches_ref(out_b, ref_b)
    assert len(cache._shards[0].bases) == 2


def test_capacity_must_cover_every_shard():
    with pytest.raises(ValueError, match="split over"):
        DeviceBatchCache(3, n_shards=4)
    with pytest.raises(ValueError, match="n_shards"):
        DeviceBatchCache(8, n_shards=0)


def test_retire_slots_drops_departed_workers_bases():
    ds = _ds()
    cache = DeviceBatchCache(64, n_shards=1)
    out_a, _, ref_a = _shard_round(ds, [1, 2], cache, 0, shard=0, slot=0)
    _shard_round(ds, [3, 4], cache, 0, shard=0, slot=1)
    assert len(cache._shards[0].bases) == 2
    cache.retire_slots(0, 1)
    assert len(cache._shards[0].bases) == 1
    assert all(k[2] == 0 for k in cache._shards[0].bases)
    assert cache._shards[0].max_slot == 0
    _assert_matches_ref(out_a, ref_a)
    assert cache.clients_cached == 4
    cache.retire_slots(0, 0)
    assert len(cache._shards[0].bases) == 0


# -- orphan-shard reclamation (tests/test_reclaim.py) ------------------------
def _one_worker_plan(ds, cids, *, steps_cap=3):
    return plan_round(*_assignment(ds, cids, workers=1), steps_cap=steps_cap)


def test_rebalance_moves_budget_and_drops_dead_entries():
    ds = _ds()
    cache = DeviceBatchCache(16, n_shards=2)
    _shard_round(ds, [0, 1], cache, 0, shard=0)
    _shard_round(ds, [2, 3], cache, 0, shard=1)
    assert cache.shard_for_client(2) == 1
    ev = cache.rebalance({0})
    assert ev is not None
    assert ev["capacities"] == [16, 0]
    assert ev["rows_moved"] == 8
    st = cache.stats()
    assert [s["capacity_rows"] for s in st["per_shard"]] == [16, 0]
    assert sum(s["capacity_rows"] for s in st["per_shard"]) == \
        st["capacity_rows"]
    assert st["per_shard"][1]["clients_cached"] == 0
    assert cache.shard_for_client(2) is None
    assert cache.shard_for_client(0) == 0
    assert cache.rebalance({0}) is None


def test_rebalance_restore_evicts_survivors_back_under_budget():
    ds = _ds()
    cache = DeviceBatchCache(16, n_shards=2)
    cache.rebalance({0})
    _shard_round(ds, [0, 1, 2, 3], cache, 1, shard=0)
    grown = cache.stats()["per_shard"][0]
    assert grown["rows_used"] > 8 or grown["clients_cached"] == 4
    ev = cache.rebalance({0, 1})
    assert ev["capacities"] == [8, 8]
    st = cache.stats()
    assert st["per_shard"][0]["rows_used"] <= 8
    assert st["per_shard"][0]["reclaim_evictions"] > 0
    for key in ("hit_steps", "miss_steps", "insertions", "evictions",
                "reclaim_evictions"):
        assert sum(s[key] for s in st["per_shard"]) == st[key], key


def test_shrink_then_regrow_never_double_books_rows():
    cache = DeviceBatchCache(8, n_shards=1)
    sh = cache._shards[0]
    ds = _ds()
    plan = _one_worker_plan(ds, [0], steps_cap=4)
    S = s_bucket(plan.s_real)
    cache.plan(plan, S, 0)
    nb_a = sh.rows_used()
    cache.plan(_one_worker_plan(ds, [1], steps_cap=4), S, 0)
    assert len(sh.entries) == 2
    cache._resize_shard(sh, sh.rows_used() - nb_a)
    held = {int(r) for e in sh.entries.values() for r in e.rows}
    assert held and min(held) >= nb_a
    assert set(sh.free).isdisjoint(held)
    cache._resize_shard(sh, 8)
    assert set(sh.free).isdisjoint(held)
    assert len(sh.free) + sh.rows_used() == 8
    cache.plan(_one_worker_plan(ds, [2], steps_cap=4), S, 1)
    rows_all = sorted(int(r) for e in sh.entries.values() for r in e.rows)
    assert len(rows_all) == len(set(rows_all)), rows_all


def test_apply_grows_physical_pool_after_reclaim():
    ds = _ds()
    cache = DeviceBatchCache(16, n_shards=2)
    _shard_round(ds, [0, 1], cache, 0, shard=0)
    assert cache._shards[0].pool_rows == 8
    cache.rebalance({0})
    _shard_round(ds, [2, 3, 4, 5], cache, 1, shard=0)
    assert cache._shards[0].pool_rows == 16
    # the grown rows are zeros, never uninitialised memory
    out, cplan, ref = _shard_round(ds, [2, 3, 4, 5], cache, 2, shard=0)
    assert cplan.hit_steps > 0 and cplan.miss_steps == 0
    _assert_matches_ref(out, ref)


def test_affinity_treats_dead_shard_homes_as_uncached():
    cs = [ClientInfo(cid=i, n_batches=4) for i in range(4)]
    workers = [WorkerInfo(wid=0, type_name="a40"),
               WorkerInfo(wid=1, type_name="a40")]
    asg = Assignment(per_worker={0: [cs[0], cs[2]], 1: [cs[1], cs[3]]})
    shard_of_wid = {0: 0, 1: 1}
    cached = {1: 0}.get
    _, n_live = apply_cache_affinity(asg, workers, shard_of_wid, cached,
                                     live_shards={0, 1})
    assert n_live == 1
    out, n_dead = apply_cache_affinity(asg, workers, shard_of_wid, cached,
                                       live_shards={1})
    assert n_dead == 0
    assert out.per_worker == asg.per_worker


def test_telemetry_discards_dead_workers_pending_meta():
    mt = MeasuredTelemetry(policy="reuse")
    mt.record_worker_times(
        0, [(0, "a40", [4.0], 1.0, 1.1), (1, "a40", [4.0], 1.0, 9.9)],
        exec_s=2.0, n_steps=8)
    assert mt.discard_workers([1]) == 1
    assert mt.stats()["worker_rows_discarded"] == 1
    out = mt.flush(2)
    assert [w[1] for w in out.worker_meta] == [0]
    assert len(out.rows) == 2


def _reclaim_engine(events=(), *, affinity=False, telemetry="synthetic",
                    drift=0.0):
    """``tests/test_reclaim.py``'s engine (LB, 4 workers x 2 lanes over 2
    mesh shards, depth 1, 64 cache rows) with ``events`` scheduled."""
    eng = _engine(1, 64, mesh=2, cache_affinity=affinity,
                  telemetry_mode=telemetry, drift_threshold=drift)
    for ev in events:
        eng.pool.schedule(ev)
    return eng


_CHURN = (FailureEvent(round_idx=3, kind="fail", wid=1),
          FailureEvent(round_idx=3, kind="fail", wid=3))


def test_kill_last_worker_of_shard_reclaims_and_restores():
    join = FailureEvent(round_idx=7, kind="join", wid=5, type_name="a40",
                        concurrency=2)
    eng = _reclaim_engine(_CHURN + (join,), affinity=True,
                          telemetry="measured", drift=0.4)
    eng.run(3)
    st = eng.cache_stats
    assert [s["capacity_rows"] for s in st["per_shard"]] == [32, 32]
    eng.run(3)
    st = eng.cache_stats
    assert [s["capacity_rows"] for s in st["per_shard"]] == [64, 0]
    assert st["rebalances"] == 1 and st["rows_moved"] == 32
    assert st["per_shard"][1]["clients_cached"] == 0
    dead_before = st["per_shard"][1]
    eng.run(1)
    assert eng.cache_stats["per_shard"][1]["clients_cached"] == 0
    assert eng.cache_stats["per_shard"][1]["hit_steps"] == \
        dead_before["hit_steps"]
    eng.run(2)
    st = eng.cache_stats
    assert [s["capacity_rows"] for s in st["per_shard"]] == [32, 32]
    assert st["rebalances"] == 2
    for key in ("hit_steps", "miss_steps", "insertions", "evictions",
                "reclaim_evictions"):
        assert sum(s[key] for s in st["per_shard"]) == st[key], key
    eng.run(2)
    assert eng.cache_stats["per_shard"][1]["miss_steps"] > \
        st["per_shard"][1]["miss_steps"]
    cst = eng.control.stats()
    assert cst["cache_rebalances"] == 2
    assert cst["audit_violations"] == 0
    assert 1 not in cst.get("worker_residuals", {})
    assert 3 not in cst.get("worker_residuals", {})
    assert all(np.isfinite(r.loss) for r in eng.history)


def test_reclaimed_run_matches_unchurned_losses_until_the_event():
    r_quiet = _reclaim_engine().run(3)
    churn = _reclaim_engine(_CHURN)
    r_churn = churn.run(6)
    assert [r.loss for r in r_churn[:3]] == [r.loss for r in r_quiet]
    assert all(np.isfinite(r.loss) for r in r_churn)


# -- parity with the reference -----------------------------------------------
def _plan_sequence(ds, n_shards):
    """(t, shard, cids, steps_cap, live_shards) of a 12-round sequence with
    repeats (hits), an nb-mismatch, evictions, and on two shards a shard
    that dies at round 6 and comes back at round 9."""
    rng = np.random.default_rng(5)
    seq = []
    for t in range(12):
        for shard in range(n_shards):
            live = None
            if n_shards > 1:
                live = {0} if 6 <= t < 9 else {0, 1}
                if shard not in live:
                    continue
            cids = sorted(rng.choice(12, size=3, replace=False).tolist())
            seq.append((t, shard, cids, 2 if t == 4 else 3, live))
    return seq


@pytest.mark.parametrize("n_shards,rows", [(1, 12), (2, 16)])
def test_cache_matches_reference_round_by_round(n_shards, rows):
    """One plan sequence through the reference's cache (JAX on the CPU) and
    the port's: identical plans and stats every round, and the assembled
    batches (the whole round base) bitwise equal."""
    ds = _ds()
    jc = JCache(rows, n_shards=n_shards)
    tc = DeviceBatchCache(rows, n_shards=n_shards)
    last_live = None
    for t, shard, cids, cap, live in _plan_sequence(ds, n_shards):
        if live is not None and live != last_live:
            assert tc.rebalance(live) == jc.rebalance(live)
            last_live = live
        assignment, winfos = _assignment(ds, cids, workers=1)
        plan = plan_round(assignment, winfos, steps_cap=cap)
        S = s_bucket(plan.s_real)
        jp = jc.plan(plan, S, t, shard=shard)
        tp = tc.plan(plan, S, t, shard=shard)
        for f in ("miss_dst", "ins_src", "ins_dst", "hit_src", "hit_dst"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
        rows_np = gather_content_rows(ds, plan, tp.content_mask,
                                      tp.n_miss_rows, batch_size=2)
        jrows = jgather(ds, plan, jp.content_mask, jp.n_miss_rows,
                        batch_size=2)
        for k in rows_np:
            np.testing.assert_array_equal(rows_np[k], jrows[k])
        jout = jc.apply({k: jax.device_put(v) for k, v in jrows.items()},
                        jp)
        tout = tc.apply(_miss(rows_np), tp)
        for k in jout:
            np.testing.assert_array_equal(tout[k].numpy(),
                                          np.asarray(jout[k]))
        assert tp.bytes_saved == jp.bytes_saved
        assert tc.stats() == jc.stats(), t


def test_engine_cache_tracks_reference_engine():
    """The port's SR engine with the cache against the reference's engine
    with the cache, on the reference's dataset and weights: same cohorts,
    hit rates and bytes saved exactly; losses within rtol 1e-5."""
    cfg = dict(device_cache_batches=24)
    j = par.system_engine(False, sampler=JZipf(64, 8, a=1.2), **cfg).run(6)
    t = par.system_engine(True, sampler=ZipfSampler(64, 8, a=1.2),
                          **cfg).run(6)
    for f in ("n_clients", "s_steps", "cache_hit_rate", "cache_bytes_saved",
              "makespan"):
        assert [getattr(r, f) for r in t] == [getattr(r, f) for r in j], f
    assert sum(r.cache_hit_rate for r in t) > 0
    np.testing.assert_allclose([r.loss for r in t], [r.loss for r in j],
                               rtol=1e-5)


@pytest.mark.parametrize("mesh", [0, 2], ids=["fused", "mesh"])
def test_losses_bitwise_with_cache_on_and_off_at_every_depth(mesh):
    plain = [r.loss for r in _engine(0, 0, mesh=mesh).run(6)]
    for depth in DEPTHS:
        eng = _engine(depth, 48, mesh=mesh)
        res = eng.run(6)
        assert [r.loss for r in res] == plain, depth
        st = eng.cache_stats
        assert st["hit_steps"] > 0
        assert st["bytes_saved"] == st["hit_steps"] * _probe_row_bytes(
            eng.dataset, batch_size=4)
        if mesh:
            for key in ("hit_steps", "miss_steps", "bytes_saved"):
                assert sum(s[key] for s in st["per_shard"]) == st[key], key
