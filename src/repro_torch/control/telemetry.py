"""Measured telemetry with a depth-aware refit barrier.

The open-loop engine draws *synthetic* client times at prepare time (valid
because they depend only on the assignment).  Closing the loop means the
times come from real execution — which, under deep pipelining, finishes
*after* the producer has already started preparing later rounds.  This
module provides the consumer-side recording and the producer-side barrier
that keeps the paper's refit protocol honest at any ``pipeline_depth``:

* :meth:`MeasuredTelemetry.record` — consumer side, called right after the
  device sync for round ``t``: attributes the measured round execution time
  back to clients proportionally to their predicted share (the per-worker
  attribution described in ``repro_torch.core.telemetry``; exact per-client rows
  via :meth:`record_rows` when a real cluster / the simcluster harness has
  them) and marks round ``t`` *finished*.
* :meth:`MeasuredTelemetry.record_worker_times` — the mesh-execution path
  (``EngineConfig.mesh_workers``): the engine syncs one device program per
  worker, so each worker's wall time is **measured exactly** on any
  backend; only the split *within* a worker (t_w over its clients,
  proportional to batch count) is interpolated.  The round-level
  predicted-share attribution path is then unused — ``rows_attributed``
  stays 0, test-enforced — and per-worker (predicted, measured) pairs ride
  the barrier for drift accounting.
* :meth:`MeasuredTelemetry.flush` — producer side, called at the start of
  preparing round ``u``: releases only rows from rounds that have already
  finished executing.  Policy ``"stall"`` blocks until round ``u - 2`` (the
  :class:`~repro_torch.core.timemodel.TrainingTimeModel` cutoff) has finished, so
  the fit for round ``u`` sees exactly the rounds a depth-0 run would;
  policy ``"reuse"`` never blocks — the fit deterministically reuses the
  last model until the data arrives (the fast path in
  ``TrainingTimeModel.refit`` makes that reuse free).

Every flush is journaled (:attr:`audit`) with the rounds it released and a
monotonic sequence number shared with the finish log, so a test — or
:func:`audit_violations` in CI — can prove that **no round ever consumed
telemetry from a round that had not finished when it was prepared**.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

__all__ = ["MeasuredTelemetry", "FlushResult", "audit_violations"]


@dataclass
class FlushResult:
    """What one producer-side flush released."""

    round_idx: int  # the round being prepared
    rows: list  # [(round, worker_type, x, seconds)] newly released
    round_meta: list  # [(round, exec_s, n_steps, n_clients)] newly released
    worker_meta: list = field(default_factory=list)
    # [(round, wid, worker_type, pred_s, meas_s)] — mesh path only
    stall_s: float = 0.0
    stalled: bool = False


@dataclass
class _AuditEntry:
    round_idx: int  # the round whose prep flushed
    seq: int  # sequence number at flush time
    released: tuple  # finished rounds released by this flush
    last_finished: int  # newest finished round at flush time
    aborted: bool = False  # flush released early by abort(); the run errored


@dataclass
class MeasuredTelemetry:
    """Thread-safe finish-time log + pending-row buffer + refit barrier.

    The consumer thread only ever calls :meth:`record` / :meth:`record_rows`;
    the producer thread only ever calls :meth:`flush`.  All state is guarded
    by one condition variable, which is also what ``"stall"`` waits on.
    """

    policy: str = "reuse"  # "reuse" | "stall"
    stall_timeout_s: float = 120.0
    last_finished: int = -1
    stalls: int = 0
    stall_s_total: float = 0.0
    flushes: int = 0
    rows_recorded: int = 0
    rows_flushed: int = 0
    rows_attributed: int = 0  # via predicted-share attribution (record)
    rows_exact: int = 0  # via exact measurement (record_rows / worker times)
    worker_rows_discarded: int = 0  # pending per-worker meta dropped on fail
    finish_seq: dict = field(default_factory=dict)  # round -> seq
    prep_seq: dict = field(default_factory=dict)  # round -> seq
    audit: list = field(default_factory=list)  # [_AuditEntry]

    def __post_init__(self):
        if self.policy not in ("reuse", "stall"):
            raise ValueError(f"barrier policy must be 'reuse' or 'stall', got {self.policy!r}")
        self._cond = threading.Condition()
        self._pending_rows: list = []  # [(round, type, x, t)]
        self._pending_meta: list = []  # [(round, exec_s, n_steps, n_clients)]
        self._pending_workers: list = []  # [(round, wid, type, pred, meas)]
        self._seq = 0
        self._aborted = False

    # -- consumer side -------------------------------------------------------
    def record(self, round_idx: int, exec_s: float, shares, n_steps: int) -> None:
        """Attribute round ``round_idx``'s measured execution time to clients.

        ``shares`` is ``[(worker_type, x, predicted_share)]`` computed at
        *prepare* time (producer side) so no placement-model state is read
        from the consumer thread.  Each client is charged
        ``exec_s * share / sum(shares)`` seconds.
        """
        shares = list(shares or [])
        total = sum(s for (_, _, s) in shares)
        rows = []
        if total > 0:
            for tname, x, s in shares:
                rows.append((round_idx, tname, float(x), exec_s * s / total))
        self._finish(round_idx, rows, exec_s, n_steps, len(shares), exact=False)

    def record_rows(self, round_idx: int, rows, *, exec_s: float | None = None) -> None:
        """Record exact per-client rows ``[(worker_type, x, seconds)]`` — the
        real-cluster / simcluster path where per-client times are measured
        directly instead of attributed."""
        rows = [(round_idx, str(t), float(x), float(s)) for (t, x, s) in rows]
        total = exec_s if exec_s is not None else sum(r[3] for r in rows)
        self._finish(round_idx, rows, float(total), len(rows), len(rows))

    def record_worker_times(
        self, round_idx: int, workers, *, exec_s: float, n_steps: int
    ) -> None:
        """Record exact per-worker wall times (the mesh execution path).

        ``workers`` is ``[(wid, worker_type, xs, pred_s, meas_s)]`` — one
        entry per worker program the engine synced: ``xs`` the batch counts
        of that worker's clients, ``pred_s`` its predicted (prepare-time)
        load, ``meas_s`` its measured wall time.  Each worker's time is
        split over its own clients proportionally to batch count — the
        worker-level total is exact; no prediction enters the split.  The
        per-worker (pred, meas) pairs are buffered alongside and released
        by the same barrier flush, feeding per-worker drift residuals.
        """
        rows, wmeta = [], []
        for wid, tname, xs, pred_s, meas_s in workers:
            xs = [float(x) for x in xs]
            total_x = sum(xs)
            if total_x > 0:
                for x in xs:
                    rows.append((round_idx, str(tname), x, float(meas_s) * x / total_x))
            wmeta.append((round_idx, int(wid), str(tname), float(pred_s), float(meas_s)))
        self._finish(round_idx, rows, float(exec_s), int(n_steps), len(rows), workers=wmeta)

    def _finish(
        self, round_idx, rows, exec_s, n_steps, n_clients, *, exact=True, workers=None
    ) -> None:
        with self._cond:
            if exact:
                self.rows_exact += len(rows)
            else:
                self.rows_attributed += len(rows)
            if workers:
                self._pending_workers.extend(workers)
            self._pending_rows.extend(rows)
            self._pending_meta.append((round_idx, float(exec_s), int(n_steps), int(n_clients)))
            self.rows_recorded += len(rows)
            self._seq += 1
            self.finish_seq[round_idx] = self._seq
            if round_idx > self.last_finished:
                self.last_finished = round_idx
            self._cond.notify_all()

    # -- producer side -------------------------------------------------------
    def flush(self, round_idx: int) -> FlushResult:
        """Release telemetry for the prep of round ``round_idx``.

        Only rows from rounds that have *finished* may leave the pending
        buffer.  Under ``"stall"`` the call blocks until round
        ``round_idx - 2`` has finished (the refit cutoff); under ``"reuse"``
        it returns immediately with whatever is available.
        """
        need = round_idx - 2
        out = FlushResult(round_idx=round_idx, rows=[], round_meta=[])
        with self._cond:
            if self.policy == "stall" and self.last_finished < need:
                out.stalled = True
                self.stalls += 1
                t0 = time.perf_counter()
                ok = self._cond.wait_for(
                    lambda: self.last_finished >= need or self._aborted,
                    timeout=self.stall_timeout_s,
                )
                out.stall_s = time.perf_counter() - t0
                self.stall_s_total += out.stall_s
                if not ok and not self._aborted:
                    raise RuntimeError(
                        f"refit barrier timed out after {self.stall_timeout_s}s "
                        f"waiting for round {need} (last finished: "
                        f"{self.last_finished})"
                    )
            allowed = self.last_finished
            keep_rows, keep_meta, keep_workers = [], [], []
            released = set()
            for r in self._pending_rows:
                if r[0] <= allowed:
                    out.rows.append(r)
                    released.add(r[0])
                else:
                    keep_rows.append(r)
            for m in self._pending_meta:
                if m[0] <= allowed:
                    out.round_meta.append(m)
                    released.add(m[0])
                else:
                    keep_meta.append(m)
            for w in self._pending_workers:
                if w[0] <= allowed:
                    out.worker_meta.append(w)
                else:
                    keep_workers.append(w)
            self._pending_rows = keep_rows
            self._pending_meta = keep_meta
            self._pending_workers = keep_workers
            self.rows_flushed += len(out.rows)
            self.flushes += 1
            self._seq += 1
            self.prep_seq[round_idx] = self._seq
            self.audit.append(
                _AuditEntry(
                    round_idx=round_idx,
                    seq=self._seq,
                    released=tuple(sorted(released)),
                    last_finished=allowed,
                    aborted=self._aborted,
                )
            )
        return out

    def discard_workers(self, wids) -> int:
        """Drop pending per-worker meta rows of failed workers.

        A worker can fail between the consumer recording its exact wall
        time and the producer flushing it: without this, a later flush
        would resurrect the dead wid's drift-residual EWMA that the
        pool-event handler just removed (and, after an orphaned mesh shard
        is reclaimed, keep attributing telemetry to a worker that no longer
        exists).  Per-client rows are kept — they are typed, not wid'd, and
        the measurements were real.  Returns the number of rows dropped.
        """
        wids = {int(w) for w in wids}
        with self._cond:
            before = len(self._pending_workers)
            self._pending_workers = [w for w in self._pending_workers if int(w[1]) not in wids]
            dropped = before - len(self._pending_workers)
            self.worker_rows_discarded += dropped
        return dropped

    # -- lifecycle -----------------------------------------------------------
    def begin_run(self, first_round: int) -> None:
        """Arm the barrier for a run starting at ``first_round``: rounds
        before it are finished by definition (sequential consumer), and a
        previous abort is cleared."""
        with self._cond:
            self._aborted = False
            if first_round - 1 > self.last_finished:
                self.last_finished = first_round - 1
            self._cond.notify_all()

    def abort(self) -> None:
        """Wake any stalled producer (a device-step failure would otherwise
        leave it blocked until the timeout)."""
        with self._cond:
            self._aborted = True
            self._cond.notify_all()

    def reset(self, round_idx: int) -> None:
        """Checkpoint restore: pending rows belong to rounds that will re-run
        (and re-record); drop them, rewind the finish marker, and start a
        fresh audit journal — the old one describes a timeline about to be
        replayed (re-running round r would overwrite ``finish_seq[r]`` with
        a later sequence number and make every pre-restore flush look like
        a violation)."""
        with self._cond:
            self._pending_rows = []
            self._pending_meta = []
            self._pending_workers = []
            self._aborted = False
            self.last_finished = round_idx - 1
            self.audit = []
            self.finish_seq = {}
            self.prep_seq = {}

    def state_dict(self) -> dict:
        """JSON-safe snapshot of the pending buffers and finish marker,
        taken under the lock (the producer snapshots while the consumer may
        be recording).  The audit journal and sequence counters are NOT
        persisted — they describe this process's timeline, and a restored
        run starts a fresh one (same as :meth:`reset`)."""
        with self._cond:
            return {
                "last_finished": self.last_finished,
                "pending_rows": [list(r) for r in self._pending_rows],
                "pending_meta": [list(m) for m in self._pending_meta],
                "pending_workers": [list(w) for w in self._pending_workers],
            }

    def load_state(self, state: dict, round_idx: int) -> None:
        """Checkpoint restore into a run resuming at ``round_idx``: reload
        the pending (recorded-but-unflushed) buffers so the next flush
        releases them instead of refitting on a hole, drop any row from a
        round that will re-run (>= ``round_idx`` — it would double-count
        when the replay re-records it), and restart the audit journal."""
        with self._cond:
            self._pending_rows = [
                (int(r[0]), str(r[1]), float(r[2]), float(r[3]))
                for r in state.get("pending_rows") or []
                if int(r[0]) < round_idx
            ]
            self._pending_meta = [
                (int(m[0]), float(m[1]), int(m[2]), int(m[3]))
                for m in state.get("pending_meta") or []
                if int(m[0]) < round_idx
            ]
            self._pending_workers = [
                (int(w[0]), int(w[1]), str(w[2]), float(w[3]), float(w[4]))
                for w in state.get("pending_workers") or []
                if int(w[0]) < round_idx
            ]
            self._aborted = False
            # Sequential consumer: every round before the restore point is
            # finished by definition (the snapshot's own marker may lag it
            # at depth > 1).
            self.last_finished = round_idx - 1
            self.audit = []
            # Retained pending rows were recorded at their round's finish,
            # before the snapshot: seed their finish marker at seq 0 (every
            # live seq is >= 1) so the flush that releases them after the
            # restore doesn't read as releasing a round that never finished.
            self.finish_seq = {
                r: 0
                for r in {row[0] for row in self._pending_rows}
                | {m[0] for m in self._pending_meta}
                | {w[0] for w in self._pending_workers}
            }
            self.prep_seq = {}

    @property
    def stall_fraction(self) -> float:
        return self.stalls / self.flushes if self.flushes else 0.0

    def stats(self) -> dict:
        return {
            "policy": self.policy,
            "flushes": self.flushes,
            "stalls": self.stalls,
            "stall_fraction": self.stall_fraction,
            "stall_s_total": self.stall_s_total,
            "rows_recorded": self.rows_recorded,
            "rows_flushed": self.rows_flushed,
            "rows_attributed": self.rows_attributed,
            "rows_exact": self.rows_exact,
            "worker_rows_discarded": self.worker_rows_discarded,
            "pending_rows": len(self._pending_rows),
            "pending_worker_rows": len(self._pending_workers),
            "last_finished": self.last_finished,
        }


def audit_violations(mt: MeasuredTelemetry) -> list[str]:
    """Check the barrier invariant over a finished run.

    Returns one message per violation (empty list == the run never let a
    prep consume telemetry from a round that had not finished first), plus
    — under the ``"stall"`` policy — per-prep completeness: every round up
    to the cutoff must have been released by the time the prep flushed.
    """
    bad: list[str] = []
    for entry in mt.audit:
        for r in entry.released:
            fseq = mt.finish_seq.get(r)
            if fseq is None:
                bad.append(f"prep {entry.round_idx} released round {r} that never finished")
            elif fseq >= entry.seq:
                bad.append(
                    f"prep {entry.round_idx} released round {r} before it "
                    f"finished (finish seq {fseq} >= flush seq {entry.seq})"
                )
        if mt.policy == "stall" and entry.round_idx - 2 >= 0 and not entry.aborted:
            # An abort() legitimately releases a stalled flush early (the
            # run is erroring out); completeness only binds healthy flushes.
            if entry.last_finished < entry.round_idx - 2:
                bad.append(
                    f"stall policy let prep {entry.round_idx} proceed with "
                    f"last finished round {entry.last_finished} < cutoff "
                    f"{entry.round_idx - 2}"
                )
    return bad
