"""The training loop (``repro.training.train_loop``): a train-step factory
with optional int8 gradient compression, periodic checkpoints and
crash-restart resume.

Training runs on the model's device (``build_model(cfg, device)``,
default CUDA, which raises without it) on the plain impls: a model whose
config asks for a kernel impl (``attention_impl="cuda"``,
``quantize="int8_cuda"``) is refused by ``make_train_step``, the kernels
having no backward. This is the counterpart of ``repro`` training on XLA.
On a mesh (``build_model(cfg, device, parallel=...)``, params placed by
``sharding.param_specs``) the step is the same code on DTensors: the
backward runs in the model's ``mesh_context``, and ``adamw_update`` takes
the norm of the whole tree and updates each rank's shards.

The train state is ``{"params", "opt": AdamWState, "gen"}``, ``gen`` a
``torch.Generator`` on the model's device that draws the compression
noise (``repro`` splits a ``jax.random`` key a step). A checkpoint holds
the params, the optimizer state and the generator's state; the params
load in either package, the rest in this one only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.models.model import Model
from repro_torch.training import data as data_lib
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update)
from repro_torch.tree import leaves, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    grad_compression: bool = False   # int8 stochastic-rounding compression


def _compress_grads_int8(grads: Dict[str, Any],
                         gen: torch.Generator) -> Dict[str, Any]:
    """Simulated gradient compression: each leaf quantized to int8 with
    its own scale (max |g| / 127) by stochastic rounding, then
    dequantized. Noise is drawn from ``gen`` leaf by leaf in sorted key
    order."""
    out = {}
    for key, g in leaves(grads):
        g32 = g.float()
        scale = torch.clamp(torch.amax(torch.abs(g32)), min=1e-12) / 127.0
        noise = torch.rand(g.shape, generator=gen, dtype=torch.float32,
                           device=g.device) - 0.5
        q = torch.clamp(torch.round(g32 / scale + noise), -127, 127)
        out[key] = (q * scale).to(g.dtype)
    return unflatten(grads, out)


def loss_and_grads(model: Model, params: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]):
    """(``model.loss`` at ``params`` as a detached 0-d tensor, its grads in
    ``params``' nested structure); a leaf the loss does not reach gets
    zeros. The params are leaves that require grad only during the call.
    On a mesh the backward runs in the model's ``mesh_context`` as the
    forward does."""
    keyed = list(leaves(params))
    with torch.enable_grad(), model.mesh_context():
        for _, p in keyed:
            p.requires_grad_(True)
        try:
            loss = model.loss(params, batch)
            gs = torch.autograd.grad(loss, [p for _, p in keyed],
                                     allow_unused=True)
        finally:
            for _, p in keyed:
                p.requires_grad_(False)
    return loss.detach(), unflatten(params, {
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(keyed, gs)})


def make_train_step(model: Model, tcfg: TrainConfig = TrainConfig()
                    ) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state
    is updated in place. Metrics: ``loss`` and ``grad_norm`` (0-d device
    tensors) and ``lr``."""
    cfg = model.cfg
    if cfg.attention_impl == "cuda" or cfg.quantize == "int8_cuda":
        raise ValueError(
            f"make_train_step: config {cfg.name!r} asks for a kernel impl "
            f"(attention_impl={cfg.attention_impl!r}, quantize="
            f"{cfg.quantize!r}) and the kernels have no backward; build the "
            "model with build_model(cfg, device), without for_device")

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        loss, grads = loss_and_grads(model, state["params"], batch)
        if tcfg.grad_compression:
            grads = _compress_grads_int8(grads, state["gen"])
        params, opt, info = adamw_update(tcfg.opt, grads, state["opt"],
                                         state["params"])
        new_state = {"params": params, "opt": opt, "gen": state["gen"]}
        return new_state, {"loss": loss, **info}

    return train_step


def init_train_state(model: Model, seed: int = 0) -> Dict[str, Any]:
    params = model.init(seed)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    return {"params": params, "opt": adamw_init(params), "gen": gen}


def state_tree(state: Dict[str, Any]) -> Dict[str, Any]:
    """The train state as a checkpoint tree: params, the optimizer's step
    and moments, and the generator's state."""
    opt = state["opt"]
    return {"params": state["params"],
            "opt": {"step": opt.step, "mu": opt.mu, "nu": opt.nu},
            "rng": state["gen"].get_state()}


def _restore_into(state: Dict[str, Any], tree: Dict[str, Any]) -> None:
    """Copy a loaded checkpoint tree (host tensors) into the live state."""
    live = dict(leaves({"params": state["params"], "mu": state["opt"].mu,
                        "nu": state["opt"].nu}))
    loaded = dict(leaves({"params": tree["params"], "mu": tree["opt"]["mu"],
                          "nu": tree["opt"]["nu"]}))
    with torch.no_grad():
        for k, t in live.items():
            t.copy_(loaded[k])
    state["opt"] = AdamWState(step=tree["opt"]["step"].to(torch.int32),
                              mu=state["opt"].mu, nu=state["opt"].nu)
    state["gen"].set_state(tree["rng"])


def train(model: Model, dcfg: data_lib.DataConfig,
          steps: int, tcfg: TrainConfig = TrainConfig(),
          ckpt_dir: Optional[str] = None,
          fail_at_step: Optional[int] = None,
          log: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    """Run (or resume) training on the model's device. ``fail_at_step``
    injects a crash for the restart tests. Returns ``{"state", "losses",
    "resumed_from", "grad_norms", "step_s"}``, the last two a step each:
    the norm before clipping and the host seconds of the step, which end
    when its loss is read."""
    log = log or (lambda s: None)
    step_fn = make_train_step(model, tcfg)
    mgr = CheckpointManager(ckpt_dir, keep=tcfg.ckpt_keep) if ckpt_dir \
        else None

    state = init_train_state(model, dcfg.seed)
    start = 0
    resumed_from = None
    if mgr is not None and mgr.latest_step() is not None:
        start, tree = mgr.restore(like=state_tree(state))
        _restore_into(state, tree)
        resumed_from = start
        log(f"resumed from checkpoint at step {start}")

    losses, norms, secs = [], [], []
    for step in range(start, steps):
        if fail_at_step is not None and step == fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in data_lib.batch_at_step(model.cfg, dcfg,
                                                    step).items()}
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        secs.append(time.perf_counter() - t0)
        losses.append(loss)
        norms.append(float(metrics["grad_norm"]))
        if step % tcfg.log_every == 0:
            log(f"step {step}: loss={loss:.4f} "
                f"lr={float(metrics['lr']):.2e}")
        if mgr is not None and (step + 1) % tcfg.ckpt_every == 0:
            mgr.save(step + 1, state_tree(state))
    if mgr is not None:
        mgr.save(steps, state_tree(state))
    return {"state": state, "losses": losses, "resumed_from": resumed_from,
            "grad_norms": norms, "step_s": secs}
