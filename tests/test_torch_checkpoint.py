"""The port's checkpoints: the store and its files against the
reference's, and exact resume of the engine.

* ``save_pytree`` writes the reference's leaf keys, and each package loads
  the other's ``.npz``; an engine checkpoint of either package restores
  into the other bit for bit.
* A resumed run's losses and makespans are bitwise the uninterrupted
  run's — fused, int8 and top-k mesh paths, at pipeline depths 0-2
  (``tests/test_system.py:65`` and ``:81``,
  ``tests/test_compress_combine.py:142`` and ``:155`` on the port).
"""

import json
import os
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import _torch_parity as par  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401
from repro.checkpoint import store as jstore  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

MIXED = [("a40", 1.0, 2), ("2080ti", 0.42, 2)]
MESH = dict(workers=4, mesh_workers=2, combine_mode="tree")


class _Pair(NamedTuple):
    mu: np.ndarray
    nu: np.ndarray


def _tree():
    rng = np.random.default_rng(0)

    def a(*s):
        return rng.standard_normal(s).astype(np.float32)

    return {"stem": a(3, 4), "stack": {"p0": {"wq": a(2, 4, 4)},
                                       "p1": {"wq": a(2, 4, 4)}},
            "seq": [a(5), np.arange(3, dtype=np.int32)],
            "opt": _Pair(a(2), a(2)), "step": np.int32(7)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, _Pair):
        return _Pair(*[_torch_tree(v) for v in tree])
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy() if torch.is_tensor(t) else t, tree,
                     is_leaf=torch.is_tensor))]


def test_save_pytree_keys_and_files_interchange(tmp_path):
    tree = _tree()
    jstore.save_pytree(str(tmp_path / "j.npz"), tree)
    tstore.save_pytree(str(tmp_path / "t.npz"), _torch_tree(tree))
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(t.files) == sorted(j.files)
        assert "['stack']/['p0']/['wq']" in t.files and ".mu" in \
            " ".join(t.files) and "['seq']/[1]" in t.files
        for k in j.files:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])
    # The port loads the reference's file into tensors of its structure...
    got = tstore.load_pytree(str(tmp_path / "j.npz"), _torch_tree(tree))
    assert isinstance(got["opt"], _Pair) and torch.is_tensor(got["stem"])
    for a, b in zip(_leaves(got), _leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # ... and the reference loads the port's.
    back = jstore.load_pytree(str(tmp_path / "t.npz"), tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(KeyError, match="missing leaf"):
        tstore.load_pytree(str(tmp_path / "t.npz"), {"nope": torch.zeros(1)})


def test_store_manifest_keep_and_atomic_writes(tmp_path):
    store = tstore.CheckpointStore(str(tmp_path), keep=3)
    assert store.latest_round() is None
    with pytest.raises(FileNotFoundError):
        store.restore({"w": torch.zeros(2)})
    for r in range(1, 6):
        store.save(r, {"w": torch.full((2,), float(r))}, extra={"r": r},
                   aux={"e": torch.ones(1)} if r % 2 else None)
    m = json.loads((tmp_path / "manifest.json").read_text())
    assert [c["round"] for c in m["checkpoints"]] == [3, 4, 5]
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["manifest.json"] + [f"round_{r:08d}{s}" for r in (3, 4, 5)
                             for s in (".npz", ".json")]
        + ["round_00000003.aux.npz", "round_00000005.aux.npz"])
    params, rnd, extra = store.restore({"w": torch.zeros(2)}, round_idx=4)
    assert rnd == 4 and extra == {"r": 4} and params["w"].tolist() == [4, 4]
    assert store.restore_aux({"e": torch.zeros(1)}, round_idx=4) is None
    assert float(store.restore_aux({"e": torch.zeros(1)})["e"]) == 1.0
    with pytest.raises(FileNotFoundError, match="round 1"):
        store.restore({"w": torch.zeros(2)}, round_idx=1)
    # The reference reads the port's directory.
    jparams, jrnd, jextra = jstore.CheckpointStore(str(tmp_path)).restore(
        {"w": np.zeros(2, np.float32)})
    assert jrnd == 5 and jextra == {"r": 5} and jparams["w"].tolist() == [5, 5]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_engine_checkpoints_interchange(writer, tmp_path):
    """An engine checkpoint of one package restores into the other: the
    same params bit for bit, round, sampler and telemetry streams, so the
    next round draws the same cohort and placement."""
    src = par.system_engine(writer == "port", ckpt=tmp_path)
    src.run(2)
    dst = par.system_engine(writer != "port", ckpt=tmp_path)
    assert dst.restore_latest() and dst.round_idx == 2
    for k, v in src.params.items():
        np.testing.assert_array_equal(np.asarray(dst.params[k]),
                                      np.asarray(v))
    a, b = src.run(1)[0], dst.run(1)[0]
    assert (a.n_clients, a.makespan, a.s_steps) == \
        (b.n_clients, b.makespan, b.s_steps)
    np.testing.assert_allclose(a.loss, b.loss, rtol=1e-5)


def test_checkpoint_resume_is_exact(tmp_path):
    """``tests/test_system.py:65``: params equal after the restore, and the
    LB time model resumes warm (no warm-up fallback)."""
    eng1 = par.system_engine(True, ckpt=tmp_path)
    eng1.run(4)                               # checkpoints at rounds 2, 4
    saved = {k: v.clone() for k, v in eng1.params.items()}
    eng2 = par.system_engine(True, ckpt=tmp_path)
    assert eng2.restore_latest()
    assert eng2.round_idx == 4
    for k, v in saved.items():
        assert torch.equal(eng2.params[k], v)
    res = eng2.run(1)
    assert not eng2.placement.used_fallback
    assert np.isfinite(res[-1].loss)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_resumed_run_bit_identical(depth, tmp_path):
    """``tests/test_system.py:81`` at each depth: the sampler and
    synthetic-telemetry RNGs ride the checkpoint as prepare-time snapshots,
    so the resumed rounds' losses and makespans are the uninterrupted
    run's; the pool is heterogeneous so the placement depends on the
    per-type fits the draws feed."""
    ref = par.system_engine(True, specs=MIXED, depth=depth).run(6)
    par.system_engine(True, specs=MIXED, depth=depth,
                      ckpt=tmp_path).run(4)
    eng = par.system_engine(True, specs=MIXED, depth=depth, ckpt=tmp_path)
    assert eng.restore_latest() and eng.round_idx == 4
    resumed = eng.run(2)
    assert [r.loss for r in resumed] == [r.loss for r in ref[4:]]
    assert [r.makespan for r in resumed] == [r.makespan for r in ref[4:]]


@pytest.mark.parametrize("compress", ["int8", "topk"])
def test_resumed_compressed_run_matches_uninterrupted(compress, tmp_path):
    """``tests/test_compress_combine.py:142``: the residuals ride the aux
    sidecar, so restore + run is the uninterrupted run, bitwise."""
    base = par.system_engine(True, combine_compress=compress, **MESH).run(6)
    par.system_engine(True, combine_compress=compress, ckpt=tmp_path,
                      **MESH).run(4)
    eng = par.system_engine(True, combine_compress=compress, ckpt=tmp_path,
                            **MESH)
    assert eng.restore_latest() and eng.round_idx == 4
    with np.load(tmp_path / "round_00000004.aux.npz") as aux:
        assert {k.split("/")[1] for k in aux.files} == {"['s0']", "['s1']"}
    assert eng._compress.residual_norm() > 0
    res = eng.run(2)
    assert [r.loss for r in res] == [r.loss for r in base[4:]]


def test_restore_with_mismatched_compressor_warns_not_crashes(tmp_path,
                                                              capsys):
    """``tests/test_compress_combine.py:155``."""
    par.system_engine(True, combine_compress="topk", combine_topk_frac=0.05,
                      ckpt=tmp_path, **MESH).run(2)
    e = par.system_engine(True, combine_compress="topk",
                          combine_topk_frac=0.10, ckpt=tmp_path, **MESH)
    assert e.restore_latest()
    assert "combine_compress state" in capsys.readouterr().out
    assert e._compress.residual_norm() == 0.0
    e.run(1)


def test_restore_across_host_families_warns_and_zeroes_residuals(tmp_path,
                                                                capsys):
    par.system_engine(True, combine_compress="int8", hosts=1, ckpt=tmp_path,
                      **MESH).run(2)
    e = par.system_engine(True, combine_compress="int8", ckpt=tmp_path,
                          **MESH)
    assert e.restore_latest()
    assert "host layout (hosts=1)" in capsys.readouterr().out
    assert e._compress.residual_norm() == 0.0


def test_restore_of_control_plane_state_across_packages(tmp_path):
    """A reference checkpoint written with its control plane on carries
    that state: the port's engine restores it into its own control plane
    (the drift EWMAs, the slot trajectory, the measured rows' barrier),
    and an engine without a control plane ignores it, as the
    reference's does."""
    kw = dict(telemetry_mode="measured", drift_threshold=0.5,
              adapt_interval=2)
    ref = par.system_engine(False, ckpt=tmp_path, **kw)
    ref.run(2)
    saved = json.loads(json.dumps(ref._control_ckpt_state))
    eng = par.system_engine(True, ckpt=tmp_path, **kw)
    assert eng.restore_latest() and eng.round_idx == 2
    got = eng.control.state_dict()
    # the barrier resumes as if rounds 0 .. 1 had finished in order
    assert got["measured"].pop("last_finished") == 1
    saved["measured"].pop("last_finished")
    assert got == saved
    eng.run(2)
    assert eng.control.audit() == []
    plain = par.system_engine(True, ckpt=tmp_path)
    assert plain.restore_latest() and plain.control is None


def test_no_store_or_no_checkpoint_restores_nothing(tmp_path):
    assert not par.system_engine(True).restore_latest()
    assert not par.system_engine(True, ckpt=tmp_path).restore_latest()


def test_cli_ckpt_dir_and_resume(tmp_path, monkeypatch, capsys):
    """``--ckpt-dir D`` saves through the CLI's engine, ``--resume``
    restores from it: the resumed CLI run starts at the checkpoint's round
    and its round losses equal the uninterrupted engine's."""
    monkeypatch.setattr(ttrain, "set_deterministic", lambda: None)
    monkeypatch.setattr(ttrain, "resolve_device",
                        lambda d: torch.device("cpu"))
    kw = dict(task="sr", cohort=2, workers=1, concurrency=1, steps_cap=1,
              population=64, device="cpu")
    whole = [r.loss for r in ttrain.build_engine(**kw).run(2)]
    ttrain.build_engine(ckpt_dir=str(tmp_path), rounds_per_checkpoint=1,
                        **kw).run(1)
    out_json = tmp_path / "m.json"
    assert ttrain.main(["--task", "sr", "--cohort", "2", "--workers", "1",
                        "--concurrency", "1", "--steps-cap", "1",
                        "--population", "64", "--rounds", "1", "--ckpt-dir",
                        str(tmp_path), "--resume", "--metrics-out",
                        str(out_json)]) == 0
    assert "resumed from round 1" in capsys.readouterr().out
    hist = json.loads(out_json.read_text())["history"]
    assert [h["round_idx"] for h in hist] == [1]
    assert [h["loss"] for h in hist] == whole[1:]
