"""Engine producer: the preparation time the consumer waited on, per
round, in ms: ``Σ pack_time × (1 - overlap_fraction)`` over the window's
rounds, divided by the rounds."""


def read(run):
    rounds = run.window
    if not rounds:
        return None
    return 1e3 * sum(r.pack_time * (1.0 - r.overlap_fraction)
                     for r in rounds) / len(rounds)
