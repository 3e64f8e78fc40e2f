"""Round-order sidecar channel for the multihost harness.

The process-per-host harness (``launch/multihost.py``) distributes the
round loop, but the control plane is a *round-ordered* consumer: the
refit barrier's audit trail only makes sense if measured rows enter a
``MeasuredTelemetry`` in the same (flush, record) interleaving the
single-process engine would have produced.  Each rank therefore ships
one pickled :class:`SidecarRecord` per executed round — measured worker
wall times, step counts, loss — and the coordinator *replays* them into
a fresh telemetry instance in strict round order: ``flush(t)`` (the prep
of round ``t`` releasing everything recorded before it) followed by the
``record_worker_times`` rows of round ``t`` itself.  That interleaving
reproduces the sequential engine's barrier discipline exactly, so
``audit_violations()`` on the replayed instance must return ``[]`` — the
acceptance gate that the refit-barrier invariant survives distribution.

Records are plain picklable tuples-of-builtins on purpose: they cross a
``multiprocessing`` pipe, and any tensor or numpy leaf would drag device
buffers through the serializer.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field

from repro_torch.control.telemetry import MeasuredTelemetry

__all__ = ["SidecarRecord", "SidecarChannel", "replay_records"]


@dataclass(frozen=True)
class SidecarRecord:
    """One round's control-plane evidence from one host rank.

    ``worker_times`` mirrors the engine's ``prep.worker_times`` rows —
    ``(wid, type_name, xs, pred_s, meas_s)`` per worker program the rank
    actually executed (its own block only; remote workers never appear).
    """

    round_idx: int
    host: int
    exec_s: float
    n_steps: int
    worker_times: tuple = ()
    loss: float = 0.0
    combine_bytes: int = 0

    @staticmethod
    def from_round(
        *, round_idx, host, exec_s, n_steps, worker_times, loss=0.0, combine_bytes=0
    ) -> "SidecarRecord":
        rows = tuple(
            (int(wid), str(tname), tuple(float(x) for x in xs), float(pred), float(meas))
            for (wid, tname, xs, pred, meas) in (worker_times or ())
        )
        return SidecarRecord(
            round_idx=int(round_idx),
            host=int(host),
            exec_s=float(exec_s),
            n_steps=int(n_steps),
            worker_times=rows,
            loss=float(loss),
            combine_bytes=int(combine_bytes),
        )


@dataclass
class SidecarChannel:
    """Accumulates records on a rank; (de)serialises for the pipe hop."""

    records: list = field(default_factory=list)

    def push(self, record: SidecarRecord) -> None:
        self.records.append(record)

    def drain(self) -> bytes:
        """Pickle-and-clear: the per-round payload the rank ships."""
        payload = pickle.dumps(list(self.records), protocol=pickle.HIGHEST_PROTOCOL)
        self.records.clear()
        return payload

    @staticmethod
    def decode(payload: bytes) -> list:
        records = pickle.loads(payload)
        for r in records:
            if not isinstance(r, SidecarRecord):
                raise TypeError(
                    f"sidecar payload contained {type(r).__name__}, expected SidecarRecord"
                )
        return records


def replay_records(
    records, *, policy: str = "reuse", telemetry: MeasuredTelemetry | None = None
) -> MeasuredTelemetry:
    """Replay sidecar records into a ``MeasuredTelemetry`` in round order.

    For every round ``t`` present (ascending): ``flush(t)`` first — the
    producer-side release the sequential engine performs at prep — then
    the consumer-side ``record_worker_times`` rows of every rank that
    executed ``t``.  Because round ``t-1`` is always recorded before
    ``flush(t)`` runs, the barrier sees ``last_finished == t-1`` at every
    flush: no stalls even under ``policy="stall"``, and the audit trail
    is violation-free by construction.  Callers assert
    ``audit_violations(replayed) == []`` to gate the harness.
    """
    mt = telemetry if telemetry is not None else MeasuredTelemetry(policy=policy)
    by_round: dict[int, list[SidecarRecord]] = {}
    for rec in records:
        by_round.setdefault(int(rec.round_idx), []).append(rec)
    if not by_round:
        return mt
    rounds = sorted(by_round)
    mt.begin_run(rounds[0])
    for t in rounds:
        mt.flush(t)
        for rec in sorted(by_round[t], key=lambda r: r.host):
            mt.record_worker_times(
                t, list(rec.worker_times), exec_s=rec.exec_s, n_steps=rec.n_steps
            )
    return mt
