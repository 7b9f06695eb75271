"""Build and load the hand-written CUDA kernels under ``repro_torch/csrc``.

Each ``.cu`` source has a plain C interface and is compiled on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library, which
is loaded with ``ctypes``. The compiles start together (one ``nvcc`` per
source) at the first kernel call, or at ``build_all()``, into
``<repo>/build/kernels`` — a directory that ``.gitignore`` lists. A library
is named by a hash of its source and flags, so an edited source rebuilds and
an unchanged one is reused within a checkout.

Nothing here runs at import: the CPU tests import every module, and the CPU
has no ``nvcc``.

Every wrapper counts its own launches in ``launch_counts``: it adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels. Under CUDA graph capture a wrapper runs
once and launches nothing, and at replay it does not run at all: what a
wrapper counts while its thread records a capture goes to that capture's
own tally (``capturing``), not to ``launch_counts``, and the engine
credits the tally once per replay (``credit``). So launches that other
threads make or credit while one thread captures land in the totals and
never in the capture's tally. The totals are updated under a lock, and
building and binding the libraries under another: two threads that call a
kernel first at the same time build it once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Iterator

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel -> (source file, C symbol, argtypes)
KERNELS = {
    "flash_attention": (
        "flash_attention.cu", "flash_attention_fwd",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "fused_paged_decode_attention": (
        "fused_paged_decode.cu", "fused_paged_decode_fwd",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
         _I, _P]),
    "int8_matmul": (
        "int8_matmul.cu", "int8_matmul_fwd",
        [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "paged_decode_attention": (
        "paged_decode.cu", "paged_decode_fwd",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "decode_attention": (
        "decode_attention.cu", "decode_attention_fwd",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
}

# host-side helpers a library exports beside its kernel:
# symbol -> (kernel whose library holds it, argtypes)
HELPERS = {
    "int8_matmul_plan": ("int8_matmul", [_I, _I, _I, _I, ctypes.POINTER(_I)]),
    "flash_attention_wgmma_smem_bytes": ("flash_attention", [_I]),
    "decode_mma_smem_bytes": ("decode_attention", [_I]),
}

launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}
_libs: Dict[str, ctypes.CDLL] = {}   # kept alive beside their entry points
_fns: Dict[str, Any] = {}
_count_lock = threading.Lock()       # guards launch_counts
_build_lock = threading.RLock()      # guards build_all, _libs and _fns
_local = threading.local()           # .tally: the capture this thread records


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _count(name: str, n: int = 1) -> None:
    """Add ``n`` launches of ``name``: to the tally of the capture this
    thread records, if any, else to the shared totals."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + n
        return
    with _count_lock:
        launch_counts[name] += n


@contextmanager
def capturing() -> Iterator[Dict[str, int]]:
    """Around a graph capture: yields a dict that holds, on exit, the
    launches the wrappers counted on this thread inside the block, none of
    which reach ``launch_counts`` (a capture launches nothing). Other
    threads count into the totals meanwhile."""
    if getattr(_local, "tally", None) is not None:
        raise RuntimeError("capturing() does not nest")
    delta: Dict[str, int] = {}
    _local.tally = delta
    try:
        yield delta
    finally:
        _local.tally = None


def credit(delta: Dict[str, int], n: int) -> None:
    """Count ``n`` replays of a graph whose capture held ``delta``."""
    for name, k in delta.items():
        _count(name, k * n)


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(source: str) -> Path:
    text = (CSRC / source).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every kernel source not yet built, all ``nvcc``s at once.

    Returns the ``-Xptxas -v`` report (registers, shared memory, spills) of
    each source, read back from the build directory. Raises if any compile
    fails. One thread builds at a time; another that asks meanwhile waits
    and finds the libraries built.
    """
    with _build_lock:
        return _build_all()


def _build_all() -> Dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (source, _sym, _args) in KERNELS.items():
        out = _lib_path(source)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: _lib_path(src).with_suffix(".ptxas.txt").read_text()
            for name, (src, _sym, _args) in KERNELS.items()}


def _bind(key: str, kernel: str, sym: str, argtypes):
    """Entry point ``sym`` of ``kernel``'s library, cached as ``key``; the
    first caller builds and loads the library under the build lock."""
    with _build_lock:
        fn = _fns.get(key)
        if fn is not None:
            return fn
        lib = _libs.get(kernel)
        if lib is None:
            build_all()
            lib = _libs[kernel] = ctypes.CDLL(
                str(_lib_path(KERNELS[kernel][0])))
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
        return fn


def kernel_fn(name: str):
    """The C entry point of kernel ``name``, building it on first use."""
    fn = _fns.get(name)
    if fn is None:
        _source, sym, argtypes = KERNELS[name]
        fn = _bind(name, name, sym, argtypes)
    return fn


def helper_fn(sym: str):
    """A host-side helper of ``HELPERS``, building its library on first use."""
    fn = _fns.get(sym)
    if fn is None:
        kernel, argtypes = HELPERS[sym]
        fn = _bind(sym, kernel, sym, argtypes)
    return fn


def check_launch(name: str, rc: int) -> None:
    """Raise on the ``cudaGetLastError()`` code a C entry point returned."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    _count(name)
