"""Round programs (``fl/round.py`` lane loop with ``models/``: forward,
backward, optimizer, K1): device-busy time per lane-loop step, in ms —
the union of the device's activity intervals in the traced window
(``torch.profiler``), divided by its rounds' ``Σ s_steps``."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    steps = sum(r.s_steps for r in tr.rounds)
    if not steps or tr.busy_s <= 0:
        return None
    return 1e3 * tr.busy_s / steps
