"""Parallelism context passed to model builders, plus the activation-
sharding hint consulted by the layer library (``repro.distributed.parallel``
on a ``torch.distributed`` ``DeviceMesh``).

The hint is a context variable, so host-side tests and single-device runs
are unaffected: ``build_model(cfg, device, parallel=...)`` sets it around
each entry point, and ``layers.constrain_residual``, the split-K decode
and the expert-parallel MoE read it.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional, Tuple

from torch.distributed.device_mesh import DeviceMesh


def _dim(mesh: DeviceMesh, name: str) -> int:
    return mesh.mesh_dim_names.index(name)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    mesh: DeviceMesh
    data_axes: Tuple[str, ...]       # ("pod", "data") or ("data",)
    model_axis: str = "model"

    @property
    def data_size(self) -> int:
        return math.prod(self.mesh.size(_dim(self.mesh, a))
                         for a in self.data_axes)

    @property
    def model_size(self) -> int:
        return self.mesh.size(_dim(self.mesh, self.model_axis))


@dataclasses.dataclass(frozen=True)
class ActivationSharding:
    """Where layer code puts activations: batch dims on the data axes,
    the sequence dim on the model axis (sequence parallelism for the
    remat-saved residual stream). Carries the mesh so layer code can open
    local regions (the split-K decode)."""
    data_axes: Tuple[str, ...]
    model_axis: str
    data_size: int
    model_size: int
    mesh: Optional[DeviceMesh] = None

    def batch(self, n: int):
        return self.data_axes if n % self.data_size == 0 else None

    def seq(self, n: int):
        return self.model_axis if (n > 1 and n % self.model_size == 0) \
            else None


_ACT_CTX: contextvars.ContextVar[Optional[ActivationSharding]] = \
    contextvars.ContextVar("repro_torch_activation_sharding", default=None)


def get_activation_sharding() -> Optional[ActivationSharding]:
    return _ACT_CTX.get()


@contextlib.contextmanager
def using_activation_sharding(ctx: Optional[ActivationSharding]):
    """``ctx`` as the activation sharding inside the block, the previous
    one restored after it."""
    token = _ACT_CTX.set(ctx)
    try:
        yield ctx
    finally:
        _ACT_CTX.reset(token)


def activation_sharding_from(parallel: ParallelConfig) -> ActivationSharding:
    return ActivationSharding(
        data_axes=parallel.data_axes, model_axis=parallel.model_axis,
        data_size=parallel.data_size, model_size=parallel.model_size,
        mesh=parallel.mesh)
