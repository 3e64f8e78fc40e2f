"""The whole step: the model FLOPs of the window's real client steps
(:func:`perfbench.work.counts.step_flops`) over the window's elapsed time
times the card's peak for the configuration's compute dtype
(``compute_dtype``: float32 for SR, whose products run with TF32 off;
bfloat16 for Qwen3), in %."""

from perfbench.work.counts import PEAK_FLOPS, step_flops


def read(run):
    from perfbench.harness import real_steps
    cfg = run.cell["config"]
    steps = sum(real_steps(r, run.lanes) for r in run.window)
    if not steps or run.window_s <= 0:
        return None
    rows = cfg["data"]["batch_size"]
    flops = steps * step_flops(cfg, rows)
    return 100.0 * flops / (run.window_s * PEAK_FLOPS[cfg["compute_dtype"]])
