"""Roofline terms of a dry-run cell against one H100, and the counter
that gives them (``repro.launch.roofline`` on ``torch.distributed``).

    compute term    = flops      / (chips x 989 TFLOP/s)
    memory term     = bytes      / (chips x 3.35 TB/s)
    collective term = coll_bytes / 900 GB/s per card

The constants are ``sim.hardware``'s (the NVIDIA H100 SXM5 data sheet:
bf16 dense, HBM3, fourth-generation NVLink per card). NVLink joins the 8
cards of one node; a 256- or 512-card world crosses nodes, whose links
are slower, so the collective term is a lower bound.

The reference reads a compiled XLA module (``cost_analysis``, the
optimized HLO). The port has no compiler between the model and the
card: ``DeviceCost``, a dispatch mode, sees what one rank executes while
the entry point runs on fake tensors in a fake world, and counts it:

* FLOPs: ``torch.utils.flop_counter``'s formulas (the products:
  mm, bmm, addmm, baddbmm, convolutions, attention ops) on the local
  operands of each op one rank runs. An op on DTensors is not counted at
  its global shape: the mode lets DTensor dispatch it and counts the
  local ops it issues, after redistribution, and an op inside a
  ``local_map`` region is a local op already. Elementwise ops add no
  FLOPs (their cost is in the bytes).
* Bytes accessed: each local op reads its tensor operands and writes its
  result, all from memory (no fusion: an estimate from above for a fused
  program). Views move nothing and are not counted, nor is the autograd
  wrapper around a collective's result (``_NO_COPY``: a new tensor on
  meta, the same memory on a card); an in-place op writes as many bytes
  of its destination as its other operands hold.
* Collective bytes: the result bytes of each collective a rank issues,
  by family, as the reference sums them (``repro/launch/roofline.py:40-60``):
  exact for all-reduce and collective-permute, the bytes received for
  all-gather and all-to-all, and 1/group of the bytes for reduce-scatter
  (the reference's caveat).
* Peak memory: the live bytes of the storages the rank holds, its inputs
  (``hold``) and every result (collectives' too), freed when the last
  tensor on a storage dies.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Iterable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.sim.hardware import (H100_HBM_BW, H100_NVLINK_BW,
                                      H100_PEAK_FLOPS_BF16)

CONSTANTS = {"peak_flops_bf16": H100_PEAK_FLOPS_BF16,
             "hbm_bytes_per_s": H100_HBM_BW,
             "nvlink_bytes_per_s": H100_NVLINK_BW,
             "source": "NVIDIA H100 SXM5 data sheet (sim/hardware.py)"}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# op-name fragment -> family, for the functional (``_c10d_functional``),
# the in-place (``c10d``) and DTensor's own (``_dtensor``: a shard moved
# to another dim, ``shard_dim_alltoall``) collectives
_FAMILY_OF = (("all_gather", "all-gather"), ("allgather", "all-gather"),
              ("reduce_scatter", "reduce-scatter"),
              ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
              ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
              ("broadcast", "collective-permute"),
              ("send", "collective-permute"), ("recv", "collective-permute"))


_META = torch.device("meta")
# ops that copy nothing on a card but make a new tensor on meta: the
# autograd wrapper around a functional collective's result
_NO_COPY = ("_c10d_functional::_wrap_tensor_autograd",)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_family(name: str) -> Optional[str]:
    """The reference's collective family of an op name, or None."""
    if not name.startswith(("_c10d_functional", "c10d", "_dtensor")):
        return None
    return next((fam for frag, fam in _FAMILY_OF if frag in name), None)


class DeviceCost(TorchDispatchMode):
    """Counts what one rank executes (the module docstring): ``flops``,
    ``bytes_accessed``, ``collective`` bytes by family, and ``peak`` live
    bytes, of the ops on ``meta`` tensors (a dry-run's). Fake tensors are
    never counted: DTensor's sharding propagation runs each op once more
    on fake tensors of the global shapes."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collective = {k: 0 for k in COLLECTIVES}
        self._live: Dict[int, int] = {}       # storage id -> bytes
        self._kinds: Dict[Any, Any] = {}
        self.live = 0
        self.peak = 0

    # -- memory ------------------------------------------------------------

    def hold(self, tensors: Iterable[torch.Tensor]) -> int:
        """Count ``tensors`` (local shards) as live; returns the bytes of
        the storages that were new."""
        before = self.live
        for t in tensors:
            self._add(t)
        return self.live - before

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._live:
            # a storage's Python object lives as long as the storage does,
            # so its finalizer runs when the last tensor on it dies
            n = st.nbytes()
            self._live[key] = n
            weakref.finalize(st, self._free, key)
            self.live += n
            self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key)

    # -- dispatch ----------------------------------------------------------

    def _ours(self, t) -> bool:
        return t.device == _META and not isinstance(t, FakeTensor)

    def _kind(self, func):
        """(collective family or None, "wait", "view" or "op", the FLOP
        formula or None) of an op, computed once per op."""
        kind = self._kinds.get(func)
        if kind is None:
            name = func.name()
            fam = collective_family(name)
            role = ("wait" if "wait_tensor" in name else
                    "view" if func.is_view or name in _NO_COPY else "op")
            kind = self._kinds[func] = (fam, role, flop_registry.get(
                func.overloadpacket))
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = tree_leaves((args, kwargs)) if kwargs or any(
            isinstance(a, (list, tuple)) for a in args) else args
        if any(isinstance(a, DTensor) for a in ins):
            # DTensor dispatches it and issues local ops, counted below
            return NotImplemented
        out = func(*args, **kwargs)
        fam, role, flop_fn = self._kind(func)
        if role != "op" and fam is None:
            return out
        touts = [out] if isinstance(out, torch.Tensor) else [
            o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if not touts or not all(self._ours(t) for t in touts):
            return out                    # a metadata query, or not ours
        tin = [a for a in ins if isinstance(a, torch.Tensor)]
        held = {a.untyped_storage()._cdata for a in tin}
        fresh = [o for o in touts if o.untyped_storage()._cdata not in held]
        for o in fresh:
            self._add(o)
        if fam is not None:
            if role != "wait":
                self.collective[fam] += sum(_nbytes(t) for t in touts)
            return out
        if flop_fn is not None:
            self.flops += int(flop_fn(*args, **kwargs, out_val=out))
        if len(fresh) == len(touts):
            self.bytes_accessed += sum(_nbytes(t) for t in tin + touts)
        else:                                # in place: self is written
            others = sum(_nbytes(t) for t in tin[1:])
            self.bytes_accessed += others + min(_nbytes(tin[0]), others)
        return out


# ---------------------------------------------------------------------------
# the reference's terms


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_global: float
    bytes_global: float
    coll_bytes_per_dev: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(cost_per_dev: Dict[str, float],
                   coll_bytes_per_dev: float, chips: int) -> RooflineTerms:
    """The reference's terms (``repro/launch/roofline.py:87-98``) over the
    H100 constants: per-device counts times ``chips`` over ``chips``
    cards' peak rates."""
    flops_g = cost_per_dev.get("flops", 0.0) * chips
    bytes_g = cost_per_dev.get("bytes accessed", 0.0) * chips
    return RooflineTerms(
        compute_s=flops_g / (chips * H100_PEAK_FLOPS_BF16),
        memory_s=bytes_g / (chips * H100_HBM_BW),
        collective_s=coll_bytes_per_dev / H100_NVLINK_BW,
        flops_global=flops_g, bytes_global=bytes_g,
        coll_bytes_per_dev=coll_bytes_per_dev)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D training / 2*N*D inference, N the active
    parameters (``ArchConfig.active_param_count``), D the tokens."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


def analytic_compute_s(cfg, shape, chips: int) -> float:
    """The compute term from MODEL_FLOPS (x4/3 remat recompute for
    training), beside the counted one."""
    remat = 4.0 / 3.0 if shape.kind == "train" else 1.0
    return model_flops(cfg, shape) * remat / (chips * H100_PEAK_FLOPS_BF16)
