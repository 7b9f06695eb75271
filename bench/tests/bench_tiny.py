"""A tiny cell on the CPU for the benchmark's own tests: the harness in a
copy of ``bench/`` under a temporary root, with a two-layer float32 dense
configuration of the port's phi3-mini architecture and small traffic."""
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "name": "tiny.f32", "arch": "phi3-mini-3.8b", "reference": "dense",
    "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "rope_theta": 10000.0,
    "torch_dtype": "float32", "quantize": "none",
    "variant": "phi3-mini-3.8b/h100-1/bf16-b16", "latency_ms": 5000,
    "engine": {"max_batch": 4, "max_len": 64, "page_size": 16,
               "decode_block": 4, "min_bucket": 8},
}
OPEN = {"loop": "open", "rate_qps": 12.0,
        "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.6,
                   "min": 4, "max": 24},
        "output": {"dist": "uniform", "min": 2, "max": 8}}
CLOSED = {"loop": "closed", "clients": 6,
          "prompt": {"dist": "loguniform", "min": 4, "max": 24},
          "output": {"dist": "uniform", "min": 2, "max": 8}}


def make_root(tmp: Path) -> Path:
    """A root holding a copy of ``bench/`` and a ``BENCHMARK.json`` of two
    tiny cells, ``tiny-open`` and ``tiny-closed``, on ``TINY``."""
    shutil.copytree(ROOT / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = TINY
    (tmp / "bench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    for name, mix in (("tiny-open", OPEN), ("tiny-closed", CLOSED)):
        (tmp / "bench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
        (tmp / "bench" / "cells" / f"{name}.json").write_text(json.dumps(
            {"mean_gap": 1e-4}))
    spec["configs"] = [{"name": cfg["name"], "source": "test",
                        "file": "bench/configs/tiny.json", "reduced": [],
                        "why": "test"}]
    spec["workloads"] = [{"name": n, "config": cfg["name"], "traffic": n,
                          "chips": 1, "why": "test"}
                         for n in ("tiny-open", "tiny-closed")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            loop = "open" if m["name"] in (
                "ttft_p95_ms", "latency_p95_ms") or m["name"].endswith(
                ".open") else "closed"
            m["workloads"] = [f"tiny-{loop}"]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
