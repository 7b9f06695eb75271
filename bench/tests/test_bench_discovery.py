"""A configuration, a traffic mix and a per-layer metric added as new
files in a copy of ``bench/``, with their entries in ``BENCHMARK.json``,
are found by name and run with no other edit."""
import json

import bench_tiny
import torch

from bench import harness

torch.set_num_threads(1)

READER = '''
def read(run):
    return float(len(run.queries))
'''


def test_new_files_are_found_by_name(tmp_path):
    root = bench_tiny.make_root(tmp_path)
    b = root / "bench"
    cfg = dict(bench_tiny.TINY, name="tiny2.f32", num_hidden_layers=1)
    (b / "configs" / "tiny2.json").write_text(json.dumps(cfg))
    mix = dict(bench_tiny.OPEN, rate_qps=6.0)
    (b / "traffic" / "slow-open.json").write_text(json.dumps(mix))
    (b / "cells" / "tiny2-slow.json").write_text(
        json.dumps({"mean_gap": 1e-4}))
    (b / "metrics" / "sent_count.py").write_text(READER)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny2.f32", "source": "test",
                            "file": "bench/configs/tiny2.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny2-slow", "config": "tiny2.f32",
                              "traffic": "slow-open", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({
        "name": "sent_count.open", "unit": "queries", "better": "higher",
        "source": "program_counter", "layer": "test", "moves":
        "ttft_p95_ms", "workloads": ["tiny2-slow"]})
    for m in spec["end_to_end"]:
        if m["name"] in ("ttft_p95_ms", "latency_p95_ms"):
            m["workloads"].append("tiny2-slow")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell("tiny2-slow", root)
    assert cell.config["num_hidden_layers"] == 1
    assert cell.mix["rate_qps"] == 6.0
    assert [m["name"] for m in cell.per_layer] == ["sent_count.open"]
    assert {m["name"] for m in cell.end_to_end} == {
        "ttft_p95_ms", "latency_p95_ms", "setup_s"}
    out = harness.run_cell(cell, 7, 1.0, True, device="cpu")
    assert out["correct"], out["check"]
    assert out["metrics"]["sent_count.open"] == {
        "value": float(out["attempted"]), "unit": "queries"}
