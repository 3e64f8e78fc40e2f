"""End to end: the card's memory peak over set-up and window, in GiB —
``torch.cuda.max_memory_allocated()`` read once the window has closed,
before the check's reference runs.  It decides how many lanes, and so how
many clients at once, a card holds."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
