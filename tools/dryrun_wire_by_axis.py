"""One dry-run cell counted per card on a checkout of the port, with the
wire bytes of its collectives by kind and axis: ``dryrun.run_cell`` of the
tree at ``--tree`` (default: this one), every collective its counter
records also summed by ``kind/axis`` (count, wire GB, largest payload MB),
so that an older tree, whose record splits them by kind alone, is counted
the same way.  Meta tensors on the host; no card:

    PYTHONPATH=src python tools/dryrun_wire_by_axis.py --tree DIR \\
        --arch qwen3-moe-235b-a22b --shape train_4k --mesh multipod
"""

import argparse
import contextlib
import json
import os
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="multipod")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import dryrun

    by_axis: dict = {}
    counting = coll.counting

    @contextlib.contextmanager
    def tee(sink):
        def both(c):
            row = by_axis.setdefault(f"{c.kind}/{c.axis}",
                                     {"count": 0, "wire_gb": 0.0,
                                      "max_mb": 0.0})
            row["count"] += 1
            row["wire_gb"] += c.wire_bytes / 1e9
            row["max_mb"] = max(row["max_mb"], c.bytes / 1e6)
            sink(c)
        with counting(both):
            yield

    coll.counting = tee
    rec = dryrun.run_cell(args.arch, args.shape, mesh=args.mesh)
    coll.counting = counting
    print(json.dumps({
        "tree": os.path.abspath(args.tree), "arch": rec["arch"],
        "shape": rec["shape"], "mesh": rec["mesh"], "status": rec["status"],
        "policy": rec.get("policy"), "W": rec.get("W"),
        "moe_dispatch": rec.get("moe_dispatch"),
        "peak_gb": rec["memory_analysis"]["peak_live_bytes"] / 1e9,
        "fits": rec["fits"], "roofline": rec["roofline"],
        "useful_ratio": rec["useful_ratio"],
        "wire_gb_by_kind": {k: v["wire_bytes"] / 1e9 for k, v in
                            rec["collectives"]["by_kind"].items()},
        "by_kind_axis": by_axis}, indent=1))


if __name__ == "__main__":
    main()
