"""The port's process-per-host harness (``repro_torch.launch.multihost``),
on the CPU: the counterparts of ``tests/test_multihost.py``.

Two invariants ride the harness: (1) the spawned fleet is *arithmetically
invisible* — per-round losses bitwise equal to the in-process ``hosts=1``
run, every rank agrees, each rank runs only its own block's workers, and
the round-order sidecar replay keeps the refit-barrier audit clean; (2) a
host death is a *clean abort* — the coordinator dumps a flight record
(never raises), and a resume from the last rank-0 checkpoint is bitwise
the uninterrupted run.

Each run spawns real OS processes (spawn context: CUDA cannot fork), so the
ranks train SR cut to ``width=64, n_blocks=2`` on one thread
(``_torch_small_engine``), 2 ranks, at most 6 rounds.
"""

import json
import os
import pickle

import pytest

torch = pytest.importorskip("torch")

from _torch_small_engine import build_small_sr_engine  # noqa: E402
from repro_torch.control.sidecar import (SidecarChannel,  # noqa: E402
                                         SidecarRecord, replay_records)
from repro_torch.control.telemetry import audit_violations  # noqa: E402
from repro_torch.launch import multihost  # noqa: E402
from repro_torch.launch.multihost import run_multihost  # noqa: E402
from repro_torch.launch.train import build_engine  # noqa: E402
from repro_torch.obs import make_observability  # noqa: E402


def _kwargs(**over):
    """``tests/test_multihost.py``'s kwargs (SR, 4 workers over 4 mesh
    shards, tree, no compression, steps_cap 4, seed 13), on the CPU."""
    kw = dict(task="sr", workers=4, mesh_workers=4, pipeline_depth=1,
              combine_mode="tree", combine_compress="none",
              steps_cap=4, seed=13, hosts=2, device="cpu")
    kw.update(over)
    return kw


def _reference(rounds, builder=build_small_sr_engine, **over):
    eng = builder(**_kwargs(hosts=1, **over))
    return [r.loss for r in eng.run(rounds)]


# -- sidecar replay (pure, no processes) -------------------------------------
def test_sidecar_replay_keeps_audit_clean():
    recs = [SidecarRecord.from_round(
                round_idx=t, host=h, exec_s=0.1, n_steps=4,
                worker_times=[(h * 2 + w, "a40", (2.0, 1.0), 0.1, 0.11)
                              for w in range(2)])
            for t in range(5) for h in range(2)]
    for policy in ("reuse", "stall"):
        mt = replay_records(recs, policy=policy)
        assert audit_violations(mt) == []
        assert mt.rows_recorded == 5 * 2 * 2 * 2
        assert mt.stalls == 0


def test_sidecar_replay_rejects_foreign_payload():
    with pytest.raises(TypeError, match="SidecarRecord"):
        SidecarChannel.decode(pickle.dumps(["not-a-record"]))


# -- the distributed run -----------------------------------------------------
def test_multihost_bit_identical_to_in_process():
    res = run_multihost(build_small_sr_engine, _kwargs(), hosts=2, rounds=4)
    assert res.ok, res.reason
    assert res.losses == _reference(4)
    assert len(res.per_rank_losses) == 2
    assert res.per_rank_losses[0] == res.per_rank_losses[1]
    # Each rank reports its own kernel counts; on the CPU the wrappers run
    # their plain versions, which launch nothing.
    assert set(res.per_rank_launches) == {0, 1}
    assert all(n == 0 for c in res.per_rank_launches.values()
               for n in c.values())
    assert res.audit == []
    assert len(res.records) == 4 * 2
    hosts_seen = {(r.round_idx, r.host) for r in res.records}
    assert hosts_seen == {(t, h) for t in range(4) for h in range(2)}
    # each rank executed only its own block's workers
    for r in res.records:
        wids = {w[0] for w in r.worker_times}
        assert wids == ({0, 1} if r.host == 0 else {2, 3}), r


def test_multihost_rejects_mismatched_hosts():
    with pytest.raises(ValueError, match="must match"):
        run_multihost(build_small_sr_engine, _kwargs(hosts=1), hosts=2,
                      rounds=1)


# -- fault injection ---------------------------------------------------------
def test_multihost_host_death_aborts_cleanly_and_resumes_bit_exact(tmp_path):
    """Kill rank 1 inside round 3's combine exchange: ``ok=False`` (never a
    raise), a flight dump, and a fleet resumed from rank 0's checkpoint
    (round 2) finishes bitwise equal to the uninterrupted run."""
    ck = str(tmp_path / "ck")
    fpath = str(tmp_path / "flight.json")
    kw = _kwargs(ckpt_dir=ck, rounds_per_checkpoint=2)
    ref = _reference(6, rounds_per_checkpoint=2)

    obs = make_observability(trace_rounds=8, flight_rounds=8,
                             flight_path=fpath)
    res = run_multihost(build_small_sr_engine, kw, hosts=2, rounds=6,
                        kill_at=(3, 1), flight=obs.flight)
    assert not res.ok
    assert "host 1 died" in res.reason
    assert res.rounds_completed == 3
    assert res.flight_path == fpath and os.path.exists(fpath)
    with open(fpath) as f:
        blob = json.load(f)
    assert "host 1 died" in blob["reason"]
    assert blob["rounds"], blob.keys()
    assert res.audit == []
    assert {r.round_idx for r in res.records} == {0, 1, 2}

    res2 = run_multihost(build_small_sr_engine, kw, hosts=2, rounds=4,
                         resume=True)
    assert res2.ok, res2.reason
    assert res2.losses == ref[2:6]
    assert res2.audit == []


def test_multihost_cli_matches_in_process_hosts_1(capsys, monkeypatch):
    """``python -m repro_torch.launch.multihost --hosts 2 --device cpu``
    prints the fleet's losses, bitwise the in-process ``hosts=1`` run of
    the same ``build_engine`` (SR at its published widths)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the ranks' intra-op pool
    argv = ["--hosts", "2", "--device", "cpu", "--rounds", "2",
            "--workers", "2", "--mesh-workers", "2", "--steps-cap", "2"]
    assert multihost.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] and out["rounds"] == 2 and out["audit_violations"] == []
    ref = build_engine(task="sr", workers=2, mesh_workers=2,
                       combine_mode="tree", steps_cap=2, seed=1337,
                       hosts=1, device="cpu").run(2)
    assert out["losses"] == [r.loss for r in ref]
