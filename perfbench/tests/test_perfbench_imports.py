"""No module that the harness, the reference or a small CPU run of a cell
loads has the top-level name ``jax``, ``jaxlib``, ``flax`` or ``repro``
(the JAX package); ``repro_torch`` is another name.  Checked in a fresh
interpreter, since the test process itself may hold JAX for other tests."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = r"""
import json, sys
import perfbench.control, perfbench.harness, perfbench.run
import perfbench.reference.compare, perfbench.reference.fl
import perfbench.reference.qwen3, perfbench.reference.sr
from perfbench import harness
cell = harness.load_cell("sr.u1024.w4l128")
cell["traffic"].update(cohort=2, workers=1, lanes_per_worker=2, steps_cap=1,
                       warmup_rounds=2)
run, check = harness.run_cell(cell, seed=5, seconds=0.05, trace=True,
                              device="cpu")
harness.read_metrics(run, cell["end_to_end"] + cell["per_layer"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_in_a_run():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "perfbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops


def test_forbidden_names_are_whole():
    from perfbench import harness
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_fake"] = sys
        sys.modules["jaxy"] = sys
        assert not set(harness.forbidden_modules()) & {"repro_torch_fake",
                                                       "jaxy"}
        sys.modules["repro.sub"] = sys
        assert "repro" in harness.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]
