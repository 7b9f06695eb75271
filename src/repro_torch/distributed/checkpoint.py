"""Checkpoints: atomic, content-hashed save and restore of nested dicts of
tensors (``repro.distributed.checkpoint``).

Used by the training loop's checkpoint/restart and by the model
repository (loading a serving variant is the same restore). The on-disk
format is ``repro``'s: ``arrays.npz`` holds the leaves under their
"/"-joined dict keys, in ``jax.tree``'s order (sorted keys), and
``manifest.json`` each leaf's key, shape, dtype and SHA-256 of its raw
bytes; a write goes to a temporary directory renamed into place, so a
crash mid-write never leaves a torn checkpoint that restore would see. A
params tree saved by either package loads in the other, with equal hashes.

bf16 has no numpy dtype in torch: a bf16 leaf is stored as its raw 2-byte
values in the form ``np.savez`` gives an ``ml_dtypes.bfloat16`` array
(void, ``|V2``), with ``"bfloat16"`` in the manifest, and rebuilt from
them on load; a raw 2-byte integer array is read the same way.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, unflatten

BF16 = "bfloat16"


def _host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """(the numpy array stored for a leaf, its manifest dtype)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        raw = np.frombuffer(arr.tobytes(), np.int16).reshape(arr.shape)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()


def save_pytree(path: str, tree: Dict[str, Any]) -> Dict[str, str]:
    """Atomic save of a nested dict of tensors (or arrays). Returns
    {leaf key: sha256}."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = [(k, *_host_array(v)) for k, v in leaves(tree)]
    hashes = {k: _sha256(a) for k, a, _ in flat}
    manifest = {
        "treedef": f"nested dict of {len(flat)} leaves",
        "leaves": [{"key": k, "shape": list(a.shape), "dtype": dt,
                    "sha256": hashes[k]} for k, a, dt in flat],
    }
    tmpdir = tempfile.mkdtemp(dir=os.path.dirname(path) or ".")
    try:
        np.savez(os.path.join(tmpdir, "arrays.npz"),
                 **{k: a for k, a, _ in flat})
        with open(os.path.join(tmpdir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmpdir, path)
    except BaseException:
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise
    return hashes


def load_pytree(path: str, like: Optional[Dict[str, Any]] = None,
                verify: bool = True) -> Dict[str, Any]:
    """The saved tree as host tensors: in ``like``'s nested structure when
    given (its leaves are only matched by key), else as the nested dict of
    the manifest's keys. With ``verify`` a leaf whose bytes do not hash to
    the manifest's SHA-256 raises ``IOError``."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for entry in manifest["leaves"]:
            arr = data[entry["key"]]
            if verify and _sha256(arr) != entry["sha256"]:
                raise IOError(
                    f"checkpoint corruption in {path}: leaf {entry['key']}")
            flat[entry["key"]] = _to_tensor(arr, entry["dtype"])
    if like is not None:
        return unflatten(like, flat)
    out: Dict[str, Any] = {}
    for key, t in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return out


class CheckpointManager:
    """Step-indexed checkpoints with retention; restores the latest intact
    checkpoint after a crash (the train loop's restart path)."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def save(self, step: int, tree: Dict[str, Any]) -> None:
        save_pytree(self._dir(step), tree)
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_"):
                if os.path.exists(os.path.join(self.root, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Dict[str, Any], step: Optional[int] = None
                ) -> Tuple[int, Dict[str, Any]]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return step, load_pytree(self._dir(step), like=like)
