"""Readings of the check's numbers, from which a cell's limits are set;
run on the card from the root of a checkout:

    PYTHONPATH=src python3 -m perfbench.control --config sr \
        --traffic u1024.w4l128 --seeds 11,12,13 [--program] [--control] \
        [--faults] [--witness cpu|one]

For each seed it draws the cell's weights, trains the plain reference's
first rounds in full precision, and prints one JSON line per reading, with
every round's loss gap beside the compared numbers:

* ``--program``: the program's first rounds, as a benchmark run's set-up
  takes them (:func:`perfbench.harness.warm_up`), against the reference:
  the lower readings;
* ``--control``: the reference in the nearest precision below the
  configuration's (``tf32`` for float32, ``fp8`` for bfloat16) in the
  program's place: an upper reading;
* ``--faults``: the reference with half of every batch left out, and the
  program's state left unchanged by its rounds (a model that never moves
  reads 1 on both update gaps, with no run): the faults' readings;
* ``--witness cpu`` or ``--witness one``: the same reference in the
  program's place, computed on the host's CPU, or on the card one client
  at a time: two sound float32 computations in another order, which show
  how far rounding alone carries the later rounds apart.

The limits in ``perfbench/limits/<cell>.json`` are set from these.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from perfbench import harness
from perfbench.reference.compare import loss_gaps, numbers
from perfbench.reference.lowp import QUANTISERS
from perfbench.weights import make_weights

__all__ = ["program_readings", "readings", "main"]

# The control's precision, one step below the configuration's.
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def program_readings(cell: dict, seed: int, device) -> tuple[dict, dict]:
    """The program's first rounds from the benchmark's weights, as a run's
    set-up takes them: ``(theta0 on the host, {losses, theta1, thetaR})``."""
    engine, theta0, _, prog = harness.warm_up(cell, seed, device)
    del engine
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return theta0, prog


def readings(cell: dict, seed: int, *, device, program: bool,
             control: bool, faults: bool, witness: str | None = None
             ) -> list[dict]:
    cfg, traffic = cell["config"], cell["traffic"]
    R = int(traffic["warmup_rounds"])
    out = []
    if program:
        theta0, prog = program_readings(cell, seed, device)
    else:
        theta0 = {k: v.cpu() for k, v in
                  make_weights(cfg, seed, device).items()}
    t = time.perf_counter()
    ref = harness.reference_readings(cfg, traffic, seed, theta0, device, R)
    ref_s = time.perf_counter() - t

    def add(kind, other):
        out.append({"seed": seed, "reading": kind,
                    **numbers(theta0, other, ref),
                    "round_loss_gaps": loss_gaps(other, ref)})

    if program:
        add("program", prog)
    if control:
        q = CONTROL[cfg.get("torch_dtype", cfg.get("dtype"))]
        add(f"control_{q}", harness.reference_readings(
            cfg, traffic, seed, theta0, device, R, q=QUANTISERS[q]))
    if faults:
        add("fault_half_batch", harness.reference_readings(
            cfg, traffic, seed, theta0, device, R, half_batch=True))
        add("fault_state_unchanged", {"losses": ref["losses"],
                                      "theta1": theta0, "thetaR": theta0})
    if witness == "cpu":
        add("witness_cpu", harness.reference_readings(
            cfg, traffic, seed, theta0, "cpu", R))
    elif witness == "one":
        add("witness_one_by_one", harness.reference_readings(
            cfg, traffic, seed, theta0, device, R, stack=1))
    for o in out:
        o["reference_s"] = ref_s
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings for a cell's limits")
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--witness", choices=("cpu", "one"))
    args = ap.parse_args(argv)
    cell = harness.parts(args.config, args.traffic)
    for seed in (int(s) for s in args.seeds.split(",")):
        for r in readings(cell, seed, device=args.device,
                          program=args.program, control=args.control,
                          faults=args.faults, witness=args.witness):
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
