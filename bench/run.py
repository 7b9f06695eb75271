"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without the CUDA devices the cell asks
for, or if JAX or the JAX package was loaded. Kernel builds and caches stay
inside the checkout, under ``build/``.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
