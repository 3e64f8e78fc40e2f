"""End to end: the window's real (unpadded) client local steps over its
whole elapsed time on the host's clock — ``Σ (L × S − padded_steps)``
over the window's rounds, divided by the seconds of
``FederatedEngine.run(n)``."""


def read(run):
    from perfbench.harness import real_steps
    if run.window_s <= 0:
        return None
    return sum(real_steps(r, run.lanes) for r in run.window) / run.window_s
