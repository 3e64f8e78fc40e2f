"""Run (c) of ``chip_smoke.py``'s phase 14c alone on one tree of the port:
qwen3-moe-235b-a22b's ``train_4k`` plan on (data 1, model 2) without the
expert-parallel dispatch, at its published widths and dtypes cut to one
layer, 2 local steps of 2 sequences — one round on 2 gloo ranks sharing
the card against the one-process round, with the phase's checks.

``--tree DIR`` runs the checkout at ``DIR`` (default: this one): its
``chip_smoke.py`` and its ``src/``, whose MoE layer without the dispatch
may split each expert's ``F`` (an older tree) or take the ``act_shard_moe``
split.  Each rank's record gains its wire bytes by kind and axis.  To
compare two trees on the same card, run them in one call, in the order
parent, change, change, parent:

    python tools/train_sharded_compare.py --tree PARENT_DIR

It prints the phase's JSON records and needs a card.
"""

import argparse
import os
import sys

# Module level, so that the spawned ranks (which import this file again)
# load the same tree and the same patches.
_ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
_ap.add_argument("--tree", default=os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."),
                 help="the checkout to run (default: this one)")
TREE = os.path.abspath(_ap.parse_known_args()[0].tree)
sys.path[:0] = [os.path.join(TREE, "src"), TREE]

import chip_smoke as cs  # noqa: E402

RUN_C = {"arch": "qwen3-moe-235b-a22b", "mesh": (1, 2), "S": 2, "b": 2,
         "n_layers": 1, "dispatch": False}
_plan = cs._sharded_train_plan


def _without_dispatch(run, axes):
    """The tree's plan of ``run``, the dispatch dropped where the run has
    none (an older tree's ``_sharded_train_plan`` keeps the plan's)."""
    from dataclasses import replace
    plan = _plan(run, axes)
    if not run["dispatch"] and plan.cfg.moe_dispatch is not None:
        plan = replace(plan, cfg=replace(plan.cfg, moe_dispatch=None))
    return plan


def _by_kind_axis(seen: list) -> dict:
    out: dict = {}
    for c in seen:
        key = f"{c.kind}/{c.axis}"
        out[key] = out.get(key, 0.0) + c.wire_bytes
    return out


cs._sharded_train_plan = _without_dispatch
cs._wire_by_kind = _by_kind_axis
cs.TRAIN_SHARDED_RUNS = (RUN_C,)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    _ap.parse_args()
    print(f"tree {TREE}", flush=True)
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    cs.phase_build()
    cs.phase_train_sharded(torch, smi)


if __name__ == "__main__":
    main()
