"""Deterministic process-per-host simulation harness (one box) — port of
``repro/launch/multihost.py``, with its wire protocol (its ``done`` message
also carries the rank's kernel launch counts).

``EngineConfig.hosts=H`` gives the in-process engine a host level above
the shard→root combine tree; this module runs the *same arithmetic* as H
spawned OS processes, one per host group:

* **Replicated producers** — every rank builds the engine from the same
  picklable ``(builder, kwargs)`` pair, so sampling, placement, packing
  and the control plane compute identically everywhere.  Ranks diverge
  only in *execution*: a rank copies to the device and runs worker
  programs for its own host block only (``engine._host_rank``); foreign
  blocks stay ``None`` holes.
* **All-gather over pipes** — at the combine, each rank ships its ONE
  merged host partial (numpy, one array per dtype group, bit-exact) to
  the coordinator, which
  gathers the ``H`` partials and broadcasts the full list back
  (``engine._host_exchange``).  Every rank then runs the identical
  pairwise root reduction, so the model stays bitwise equal on every
  host without a broadcast of the result.
* **Round-order sidecar channel** — control-plane rows (measured worker
  wall times, step counts) cross to the coordinator as pickled
  :class:`~repro_torch.control.sidecar.SidecarRecord` batches, one per
  executed round (``engine._round_observer``); the coordinator replays
  them into a fresh ``MeasuredTelemetry`` and the refit-barrier audit
  (``audit_violations() == []``) gates the run.
* **Rank-0 checkpointing** — every rank restores (all must resume from
  the same snapshot), only rank 0 writes.  Under ``combine_compress`` a
  rank holds error-feedback residuals for its own block only, so use
  ``compress="none"`` where bit-exact resume across a failure matters.
* **Fault handling** — a dead rank surfaces as a broken pipe at the next
  gather.  The coordinator dumps a flight record (``FlightRecorder.dump``
  never raises), terminates the surviving ranks, and returns
  ``MultihostResult(ok=False)`` rather than raising.  ``kill_at=(round,
  rank)`` hard-kills a rank mid-round (``os._exit`` inside the combine).
* **Not with ``cache_affinity``** — as in the reference, a rank's cache
  holds only its own block's shards (the foreign-block hole comes before
  ``cache.plan``), but ``apply_cache_affinity`` asks ``shard_for_client``
  of that local cache, so two ranks can make different swaps and train
  different assignments: a client may then be trained twice or not at
  all.  The per-rank loss check does not see it (every rank reduces the
  same exchanged partials).  Run ``hosts > 1`` without ``cache_affinity``.

On the card the ranks are spawned processes (CUDA cannot fork), each with
its own CUDA context; every rank maps shard ``s`` to ``cuda:(s %
device_count)``, so on one card all of them share it.  The parent builds
the CUDA kernels once before spawning; each rank makes its results
deterministic (:func:`~repro_torch.launch.train.set_deterministic`) before
its first GEMM.  A host partial crosses as ``.cpu().numpy()``, one array
per dtype group (a bf16 buffer as the int16 view of its bits, since numpy
has no bf16), and comes back through ``torch.from_numpy`` (and
``.view(torch.bfloat16)``): an exact round trip in every dtype.

Wire protocol (child → coordinator, one ``Connection`` per rank)::

    ("xchg", t, rank, part | None)   # blocks for ("xchg", t, [H parts])
    ("sidecar", payload_bytes)       # pickled [SidecarRecord], per round
    ("done", losses, round_idx, launches)  # terminal success; launches
                                     # = ops.launch_counts() over engine.run
    ("err", traceback_str)           # terminal failure

Coordinator → child: only the ``("xchg", t, parts)`` replies.  Run it::

    PYTHONPATH=src python -m repro_torch.launch.multihost --hosts 2
    PYTHONPATH=src python -m repro_torch.launch.multihost --hosts 2 \\
        --device cpu --rounds 4
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch
import torch.multiprocessing as mp

from repro_torch.control.sidecar import (SidecarChannel, SidecarRecord,
                                         replay_records)
from repro_torch.control.telemetry import audit_violations

__all__ = ["MultihostResult", "run_multihost"]


@dataclass
class MultihostResult:
    """What the coordinator hands back — success or clean abort."""

    ok: bool
    hosts: int
    losses: list = field(default_factory=list)       # rank 0's per-round
    per_rank_losses: dict = field(default_factory=dict)
    records: list = field(default_factory=list)      # SidecarRecords, all ranks
    audit: list = field(default_factory=list)        # replay violations ([] == pass)
    rounds_completed: int = 0
    reason: str = ""                                 # non-empty on abort
    flight_path: str | None = None                   # dumped record on abort
    exchange_s: list = field(default_factory=list)   # per round: the
    #   coordinator's seconds reading the partials and broadcasting them
    exchange_bytes: list = field(default_factory=list)  # per round: the
    #   bytes of each rank's partial (0 for an all-holes block)
    per_rank_launches: dict = field(default_factory=dict)  # rank -> its
    #   ``ops.launch_counts()`` over its ``engine.run`` (zeros on the CPU)

    def replay_telemetry(self, *, policy: str = "reuse"):
        """Replay the sidecar records into a fresh ``MeasuredTelemetry``."""
        return replay_records(self.records, policy=policy)


def _part_nbytes(part) -> int:
    """Bytes of one rank's wire partial (0 for an all-holes block): its
    group arrays, weight and loss."""
    if part is None:
        return 0
    flats, n, loss = part
    return sum(a.nbytes for a in flats.values()) + n.nbytes + loss.nbytes


def _child_main(conn, rank, builder, kwargs, rounds, resume, kill_at):
    """Rank entry point (spawn target — top-level and fully picklable)."""
    try:
        from repro_torch.kernels import ops
        from repro_torch.launch.train import set_deterministic
        set_deterministic()     # a fresh interpreter: before its first GEMM
        engine = builder(**kwargs)
        if resume and engine.ckpt is not None:
            engine.restore_latest()
        if rank != 0:
            engine.ckpt = None      # restore-only: rank 0 owns the writes

        def exchange(t, own, part):
            if kill_at is not None and (t, own) == tuple(kill_at):
                os._exit(17)        # hard crash mid-round, mid-combine
            conn.send(("xchg", int(t), int(own), part))
            tag, t_back, parts = conn.recv()
            if tag != "xchg" or t_back != t:
                raise RuntimeError(f"host {rank}: expected the round {t} "
                                   f"exchange, got ({tag!r}, {t_back!r})")
            return parts

        channel = SidecarChannel()

        def observe(prep, result):
            channel.push(SidecarRecord.from_round(
                round_idx=prep.t, host=rank, exec_s=prep.exec_s,
                n_steps=prep.n_steps_real,
                worker_times=prep.worker_times or (),
                loss=result.loss, combine_bytes=result.combine_bytes))
            conn.send(("sidecar", channel.drain()))

        engine._host_rank = rank
        engine._host_exchange = exchange
        engine._round_observer = observe
        ops.reset_launch_counts()
        results = engine.run(rounds)
        conn.send(("done", [r.loss for r in results], engine.round_idx,
                   ops.launch_counts()))
    except BaseException:
        import traceback
        try:
            conn.send(("err", traceback.format_exc()))
        except (BrokenPipeError, OSError):
            pass
        raise SystemExit(1)
    finally:
        conn.close()


def run_multihost(builder, kwargs, *, hosts, rounds, resume=False,
                  kill_at=None, flight=None, timeout_s=600.0
                  ) -> MultihostResult:
    """Run ``rounds`` federated rounds across ``hosts`` spawned processes.

    ``builder(**kwargs)`` must construct an engine whose config has
    ``hosts=hosts`` — both must be importable/picklable (spawn context).
    ``kwargs["device"]`` is where the ranks run (``cuda`` when absent);
    on CUDA the kernels are built here first.  ``flight`` is an optional
    parent-side :class:`~repro_torch.obs.FlightRecorder`; on a host
    failure its ``dump`` runs before the surviving ranks are torn down.
    Never raises for a host death — inspect ``MultihostResult.ok`` /
    ``reason``.
    """
    hosts = int(hosts)
    if hosts < 1:
        raise ValueError("run_multihost needs hosts >= 1")
    if int(kwargs.get("hosts", 0)) != hosts:
        raise ValueError(
            f"builder kwargs carry hosts={kwargs.get('hosts', 0)} but the "
            f"harness was asked for {hosts} ranks — they must match")
    if torch.device(kwargs.get("device", "cuda")).type == "cuda":
        from repro_torch.kernels.build import build_all
        build_all()                 # once, not once per rank
    ctx = mp.get_context("spawn")
    conns, procs = [], []
    for rank in range(hosts):
        parent_c, child_c = ctx.Pipe()
        p = ctx.Process(
            target=_child_main,
            args=(child_c, rank, builder, dict(kwargs), int(rounds),
                  bool(resume), kill_at),
            name=f"pollen-host{rank}", daemon=True)
        p.start()
        child_c.close()
        conns.append(parent_c)
        procs.append(p)

    out = MultihostResult(ok=True, hosts=hosts)
    done: dict[int, tuple] = {}

    def _abort(reason):
        out.ok = False
        out.reason = reason
        if flight is not None:
            out.flight_path = flight.dump(reason)   # never raises
        for p in procs:
            if p.is_alive():
                p.terminate()

    def _pump(rank):
        """Drain one rank's messages until its next xchg (or terminal);
        returns it with the seconds its read took."""
        while True:
            if not conns[rank].poll(timeout_s):
                raise EOFError(f"host {rank} silent for {timeout_s}s")
            t0 = time.perf_counter()
            msg = conns[rank].recv()
            read_s = time.perf_counter() - t0
            tag = msg[0]
            if tag == "sidecar":
                recs = SidecarChannel.decode(msg[1])
                out.records.extend(recs)
                if flight is not None and recs:
                    r = recs[-1]
                    flight.on_round(r.round_idx, {
                        "host": r.host, "loss": r.loss,
                        "exec_s": r.exec_s,
                        "combine_bytes": r.combine_bytes})
                continue
            return msg, read_s

    try:
        while len(done) < hosts:
            pending = []        # (rank, t, part) for this gather
            xchg_s = 0.0
            for rank in range(hosts):
                if rank in done:
                    continue
                try:
                    msg, read_s = _pump(rank)
                except (EOFError, OSError) as e:
                    _abort(f"host {rank} died mid-round: {e}")
                    return out
                if msg[0] == "done":
                    done[rank] = (msg[1], msg[2], msg[3])
                elif msg[0] == "err":
                    _abort(f"host {rank} raised:\n{msg[1]}")
                    return out
                else:
                    pending.append((rank, msg[1], msg[3]))
                    xchg_s += read_s
            if pending:
                ts = {t for (_, t, _) in pending}
                if len(ts) != 1 or len(pending) + len(done) != hosts:
                    _abort(f"host ranks desynchronised at rounds {sorted(ts)}")
                    return out
                t = ts.pop()
                parts = [None] * hosts
                for rank, _, part in pending:
                    parts[rank] = part
                t0 = time.perf_counter()
                for rank, _, _ in pending:
                    try:
                        conns[rank].send(("xchg", t, parts))
                    except (BrokenPipeError, OSError) as e:
                        _abort(f"host {rank} died at broadcast: {e}")
                        return out
                out.exchange_s.append(xchg_s + time.perf_counter() - t0)
                out.exchange_bytes.append([_part_nbytes(p) for p in parts])
                out.rounds_completed = t + 1
    finally:
        # A timed join: a rank torn down mid-call must not hold the
        # coordinator in its CUDA teardown.
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        for c in conns:
            c.close()

    out.per_rank_losses = {r: d[0] for r, d in done.items()}
    out.per_rank_launches = {r: d[2] for r, d in done.items()}
    out.losses = out.per_rank_losses.get(0, [])
    ranks_disagree = any(l != out.losses
                         for l in out.per_rank_losses.values())
    if ranks_disagree:
        out.ok = False
        out.reason = "per-rank losses diverged (bit-identity broken)"
    out.audit = audit_violations(out.replay_telemetry())
    if out.audit and out.ok:
        out.ok = False
        out.reason = f"sidecar replay audit violations: {out.audit[:3]}"
    return out


def _cli_builder(**kw):
    from repro_torch.launch.train import build_engine
    return build_engine(**kw)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="process-per-host Pollen simulation on one box (port)")
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--task", default="sr")
    ap.add_argument("--mesh-workers", type=int, default=4)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--pipeline-depth", type=int, default=1)
    ap.add_argument("--combine-compress", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--steps-cap", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where every rank runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    kw = dict(task=args.task, workers=args.workers,
              mesh_workers=args.mesh_workers,
              pipeline_depth=args.pipeline_depth,
              combine_mode="tree", combine_compress=args.combine_compress,
              steps_cap=args.steps_cap, seed=args.seed,
              ckpt_dir=args.ckpt_dir, hosts=args.hosts, device=args.device)
    res = run_multihost(_cli_builder, kw, hosts=args.hosts,
                        rounds=args.rounds, resume=args.resume)
    print(json.dumps({
        "ok": res.ok, "hosts": res.hosts, "reason": res.reason,
        "rounds": res.rounds_completed, "losses": res.losses,
        "audit_violations": res.audit}, indent=1))
    return 0 if res.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
