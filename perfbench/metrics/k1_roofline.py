"""Kernel K1 (``kernels/fedavg_accum.py``, the lane fold of Eq. 1): its
share of the memory roofline, in %.  Each launch folds one dtype group's
``[L, n_g]`` (``L`` the cell's lanes, ``n_g`` the model's elements of that
dtype); its least time is its least bytes, ``2 L n_g × itemsize``
(:func:`perfbench.work.counts.fedavg_accum_bytes`), at the card's
3.35 TB/s.  The share is the launches'
summed least time over their summed kernel time in the device trace."""

from perfbench.work.counts import HBM_BYTES_PER_S, fedavg_accum_bytes

# K1's kernel for each dtype group, by the name the trace gives it.
KERNELS = {"fedavg_accum_f32": "float32", "fedavg_accum_bf16": "bfloat16"}


def read(run):
    tr = run.trace
    if tr is None:
        return None
    bound = took = 0.0
    for name, _, dur in tr.kernels:
        group = next((g for k, g in KERNELS.items() if k in name), None)
        if group is None:
            continue
        n = run.group_elems[group]
        bound += fedavg_accum_bytes(run.lanes, n, group) / HBM_BYTES_PER_S
        took += dur
    if took <= 0:
        return None
    return 100.0 * bound / took
