"""Engine producer (``core/engine.py:_prepare_round``: sample, place,
pack into the pinned ring, start the H2D copy): the mean host time a
round's preparation takes, ``RoundResult.pack_time``, in ms."""


def read(run):
    rounds = run.window
    if not rounds:
        return None
    return 1e3 * sum(r.pack_time for r in rounds) / len(rounds)
