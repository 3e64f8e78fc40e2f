"""Engine consumer (``_execute`` .. the loss sync in ``_post_execute``):
host time from dispatch to the round's device sync, per lane-loop step,
in ms: ``Σ exec_time / Σ s_steps`` over the window's rounds."""


def read(run):
    steps = sum(r.s_steps for r in run.window)
    if not steps:
        return None
    return 1e3 * sum(r.exec_time for r in run.window) / steps
