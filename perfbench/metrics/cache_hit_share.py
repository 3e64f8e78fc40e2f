"""Device batch cache (``data/device_cache.py``: hot clients' batch rows
kept on the card, the misses copied in and assembled): the share of the
window's real client steps whose batch came from the cache, in %, from
the engine's per-round hit rate (``RoundResult.cache_hit_rate``) weighted
by each round's real steps."""


def read(run):
    from perfbench.harness import real_steps
    steps = [real_steps(r, run.lanes) for r in run.window]
    if not sum(steps):
        return None
    hits = sum(r.cache_hit_rate * s for r, s in zip(run.window, steps))
    return 100.0 * hits / sum(steps)
