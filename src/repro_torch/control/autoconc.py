"""Adaptive per-worker concurrency: online hill-climbing of client slots.

The paper derives per-GPU-type concurrency offline (probe one client, read
``nvidia-smi``, Table 3); ``repro_torch.core.concurrency`` reproduces that as the
analytic / memory-analysis *seed*.  But the right slot count moves with the
workload: bigger clients need more VRAM per slot, input-pipeline contention
grows with concurrency, and a worker type that joins mid-run starts from a
guess.  :class:`AdaptiveConcurrency` closes that loop with the simplest
controller that works online: coordinate-ascent hill climbing on measured
round throughput.

Every ``interval`` rounds it finalizes the mean throughput of the closing
window, compares it against the previous window, and nudges **one** knob's
slot count by ±1 (round-robin over knobs, so concurrent knobs never
fight): keep the direction while throughput improves by at least
``min_gain``, reverse when it stops.  A *knob* is one worker type by
default; under the control plane's ``adapt_granularity="worker"`` (the
mesh path's per-worker telemetry makes this meaningful) every worker id
gets its own knob — states are keyed by opaque strings, so both
granularities share this climber unchanged.  Slot counts stay inside
``[min_slots, max_slots]`` — seed ``max_slots`` from
:func:`repro_torch.core.concurrency.estimate_slots_analytic` (HBM budget) or
:func:`~repro_torch.core.concurrency.gpu_concurrency_probe` (VRAM rule) so the
climb can never walk past what memory allows.

Deterministic: decisions depend only on the sequence of observed scores,
so a run with simulated (synthetic) throughput is bit-reproducible at any
pipeline depth — the engine feeds the *simulated* makespan in synthetic
mode and the *measured* execution time (under the refit barrier) in
measured mode.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["AdaptiveConcurrency", "SlotState"]


@dataclass
class SlotState:
    """Hill-climb state for one knob (a worker type, or one worker id)."""

    slots: int
    direction: int = 1
    prev_score: float | None = None
    best_slots: int = 0
    best_score: float = 0.0

    def __post_init__(self):
        if not self.best_slots:
            self.best_slots = self.slots


@dataclass
class AdaptiveConcurrency:
    """Coordinate-ascent hill climber over per-knob client slots (knobs are
    worker types, or individual workers under per-worker granularity)."""

    interval: int = 5  # rounds per decision window
    min_slots: int = 1
    max_slots: int = 64
    min_gain: float = 0.0  # relative improvement that counts as "better"
    states: dict = field(default_factory=dict)  # type -> SlotState
    trajectory: list = field(default_factory=list)  # (round, type, old, new)
    updates: int = 0

    def __post_init__(self):
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {self.interval}")
        if not 1 <= self.min_slots <= self.max_slots:
            raise ValueError(
                f"need 1 <= min_slots <= max_slots, got "
                f"[{self.min_slots}, {self.max_slots}]"
            )
        self._window: list = []
        self._order: list = []  # round-robin over type names
        self._turn = 0

    # -- seeding -------------------------------------------------------------
    def seed(self, type_name: str, slots: int) -> None:
        """Register a worker type at its estimated slot count (idempotent)."""
        if type_name not in self.states:
            slots = max(self.min_slots, min(self.max_slots, int(slots)))
            self.states[type_name] = SlotState(slots=slots)
            self._order = sorted(self.states)

    def forget(self, type_name: str) -> None:
        """Drop a type whose last worker failed; a rejoin reseeds."""
        if type_name in self.states:
            del self.states[type_name]
            self._order = sorted(self.states)
            self._turn = 0

    def restart_window(self) -> None:
        """Checkpoint restore: replayed rounds would double-count their
        throughput, so the open window and the last comparison point are
        dropped (slot positions stay — they are live pool state)."""
        self._window = []
        for st in self.states.values():
            st.prev_score = None

    # -- the loop ------------------------------------------------------------
    def observe_round(self, score: float) -> None:
        """Accumulate one round's throughput (clients/s, steps/s — any
        consistent rate; higher is better)."""
        self._window.append(float(score))

    def maybe_update(self, round_idx: int) -> list[tuple[str, int, int]]:
        """Close the window every ``interval`` observations and move one
        type's slot count.  Returns ``[(type, old_slots, new_slots)]`` (at
        most one entry) for the caller to apply to its worker pool."""
        if len(self._window) < self.interval or not self._order:
            return []
        score = sum(self._window) / len(self._window)
        self._window = []
        tname = self._order[self._turn % len(self._order)]
        self._turn += 1
        st = self.states[tname]
        if score > st.best_score:
            st.best_score = score
            st.best_slots = st.slots
        if st.prev_score is not None and score < st.prev_score * (1.0 + self.min_gain):
            st.direction = -st.direction
        st.prev_score = score
        old = st.slots
        new = max(self.min_slots, min(self.max_slots, old + st.direction))
        if new == old:
            # pinned at a bound: probe back inward next time
            st.direction = -st.direction
            return []
        st.slots = new
        self.updates += 1
        self.trajectory.append((round_idx, tname, old, new))
        return [(tname, old, new)]

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-safe snapshot: knob states, trajectory, and the open
        throughput window (so a restored climber closes the same window the
        uninterrupted run would have)."""
        return {
            "states": {
                t: [s.slots, s.direction, s.prev_score, s.best_slots, s.best_score]
                for t, s in self.states.items()
            },
            "trajectory": [list(e) for e in self.trajectory],
            "updates": self.updates,
            "window": list(self._window),
            "turn": self._turn,
        }

    def load_state(self, state: dict) -> None:
        """Checkpoint restore: adopt a snapshot taken by :meth:`state_dict`.
        The caller re-applies the restored slot counts to its worker pool
        (pool concurrency is live state, not part of this snapshot)."""
        self.states = {
            str(t): SlotState(
                slots=int(v[0]),
                direction=int(v[1]),
                prev_score=None if v[2] is None else float(v[2]),
                best_slots=int(v[3]),
                best_score=float(v[4]),
            )
            for t, v in (state.get("states") or {}).items()
        }
        self._order = sorted(self.states)
        self.trajectory = [tuple(e) for e in state.get("trajectory") or []]
        self.updates = int(state.get("updates", 0))
        self._window = [float(x) for x in state.get("window") or []]
        self._turn = int(state.get("turn", 0))

    # -- reading -------------------------------------------------------------
    def slots_for(self, type_name: str) -> int | None:
        st = self.states.get(type_name)
        return st.slots if st else None

    def stats(self) -> dict:
        return {
            "updates": self.updates,
            "slots": {t: s.slots for t, s in sorted(self.states.items())},
            "best_slots": {t: s.best_slots for t, s in sorted(self.states.items())},
        }
