"""No JAX in a benchmark process: a fresh interpreter imports the harness,
every configuration, mix and metric file, the references and the port's
modules a run uses, runs a tiny cell on the CPU, and must hold no module
whose top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (names
compared whole: ``repro_torch`` is the port)."""
import json
import os
import subprocess
import sys

import bench_tiny
import torch

torch.set_num_threads(1)

SCRIPT = r"""
import json, sys, tempfile
from pathlib import Path
root, tests = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, root + "/src", tests]
import torch
torch.set_num_threads(1)
import bench_tiny
from bench import calibrate, costs, harness, sweep, trace, workload
base = Path(root) / "bench"
for f in sorted(base.glob("configs/*.json")) + sorted(
        base.glob("traffic/*.json")) + sorted(base.glob("cells/*.json")):
    json.loads(f.read_text())
for f in sorted(base.glob("metrics/*.py")):
    harness.reader(f.stem, Path(root))
for f in sorted(base.glob("reference/*.py")):
    harness._load(f, "ref")
tmp = bench_tiny.make_root(Path(tempfile.mkdtemp()))
out = harness.run_cell(harness.load_cell("tiny-open", tmp), 5, 1.0, False,
                       device="cpu")
assert out["correct"], out
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_module_in_a_benchmark_process(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TMPDIR"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(bench_tiny.ROOT),
         str(bench_tiny.ROOT / "bench" / "tests")],
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "bench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}, loaded
