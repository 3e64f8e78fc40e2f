"""The device: the share of the traced window in which no operation
ran on it, in %: ``1 - busy / elapsed``, busy the union of the device's
activity intervals from ``torch.profiler``."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
