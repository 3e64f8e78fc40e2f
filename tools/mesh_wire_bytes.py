"""Wire bytes one rank sends in ``chip_smoke.py``'s mesh phases, counted on
a meta mesh (nothing computed, a few seconds on the host), by collective
kind and axis: phase 14b's jamba period on (1, 2) — a prefill of 4 x 2,048
tokens into a cache of 2,064 slots and one decode step — and phase 14c's
rounds of 2 local steps: (a) qwen3-0.6b ``tp`` on (2, 2) at b = 1, and one
layer of qwen3-moe-235b-a22b ``fsdp_tp`` on (1, 2) at ``--moe-b``
sequences (b) through the expert-parallel dispatch and (c) without it
(the ``act_shard_moe`` split on a tree that has it, else each expert's
``F`` split).

The bytes are the ring formulas of ``distributed.collectives`` on each
payload in its dtype (gloo sends a reduction's bf16 payload in f32).  Run
it from the root of any checkout of the port to compare two trees:

    PYTHONPATH=src python tools/mesh_wire_bytes.py [--moe-b 2]
"""

import argparse
import json
from dataclasses import replace

import torch

from repro_torch.configs import get_arch
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import shard_tree
from repro_torch.launch import plan as tplan
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_step
from repro_torch.models import lm

AXES = ("data", "model")


def _counted(fn) -> dict:
    """MB a rank sends while ``fn()`` runs, by ``kind/axis`` and in all."""
    seen = []
    with coll.counting(seen.append):
        fn()
    out: dict = {}
    for c in seen:
        key = f"{c.kind}/{c.axis}"
        out[key] = out.get(key, 0.0) + c.wire_bytes / 1e6
    out["total"] = sum(out.values())
    return {k: round(v, 1) for k, v in out.items()}


def serve_hybrid_mesh() -> dict:
    mesh = make_mesh((1, 2), AXES, backend="meta")
    cfg = replace(get_arch("jamba-v0.1-52b"), n_layers=8,
                  attn_impl="pallas", ssd_impl="pallas")
    plan = tplan.make_plan(cfg, "prefill_32k", mesh)
    cfg = replace(cfg, moe_dispatch=plan.cfg.moe_dispatch)
    specs = tplan.sharding_specs(plan, mesh)
    kw = {"specs": {k: specs[k] for k in ("params", "act", "logits")
                    if k in specs}, "mesh": mesh, "device": "meta"}
    kw["specs"]["cache"] = tplan.cache_specs(cfg, specs["rules"], 4, 2064,
                                             mesh)
    params = shard_tree(tplan.meta_params(cfg), specs["params"], mesh)
    tokens = torch.zeros(4, 2048, dtype=torch.long, device="meta")
    state = {}

    def prefill():
        state["cache"] = lm.prefill(params, {"tokens": tokens}, cfg,
                                    max_len=2064, **kw)[1]

    def decode():
        lm.decode_step(params, state["cache"], tokens[:, :1], 2048, cfg,
                       **kw)

    return {"prefill": _counted(prefill), "decode_step": _counted(decode)}


def train_round(arch: str, shape, b: int, n_layers,
                dispatch: bool = True) -> dict:
    mesh = make_mesh(shape, AXES, backend="meta")
    plan = tplan.make_plan(arch, "train_4k", mesh)
    cfg = plan.cfg if n_layers is None else replace(plan.cfg,
                                                    n_layers=n_layers)
    if not dispatch:
        cfg = replace(cfg, moe_dispatch=None)
    fn, args = build_step(replace(plan, S=2, b=b, cfg=cfg), "meta",
                          mesh=mesh)
    return _counted(lambda: fn(*args))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--moe-b", type=int, default=2,
                    help="sequences a step of the qwen3-moe round")
    args = ap.parse_args(argv)
    print(json.dumps({
        "serve_hybrid_mesh": serve_hybrid_mesh(),
        "train_sharded": {
            "qwen3-0.6b": train_round("qwen3-0.6b", (2, 2), 1, None),
            "qwen3-moe-235b-a22b": train_round("qwen3-moe-235b-a22b",
                                               (1, 2), args.moe_b, 1),
            "qwen3-moe-235b-a22b no dispatch": train_round(
                "qwen3-moe-235b-a22b", (1, 2), args.moe_b, 1,
                dispatch=False)}},
        indent=1))


if __name__ == "__main__":
    main()
