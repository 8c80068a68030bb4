"""LM training (the port of ``repro.launch.train``; the SSM, dense, MoE,
hybrid, audio and VLM families).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_1_6b \\
        --steps 20 --device cpu                 # reduced config, on the CPU

Optimisers: ``adamw`` (default) or ``vfb2_sgd``, the bounded-staleness
BAPA emulation (``--tau``): the paper's asynchronous update rule at
framework scale.  The q parties (``--model-parallel``) are
``Runtime.model_size`` on one device.

A step (``train_step``) takes the mean token cross-entropy of
``models.model.train_loss`` and the gradient of every parameter leaf
through autograd, on the plain routes (the sequential scan and the plain
chunked attention: the kernels are forward-only, ``kernels.ops``), then
applies the optimiser.  Tokens come from ``data.tokens``'
``synthetic_token_batches``; the masks of the secure embedding come from
a generator seeded per step from (SEED, step), so they are not the
reference's threefry bits and the two packages agree to the mask residue.
An encoder-decoder's batches carry zero frames and a VLM's zero patches,
as the reference's do (``repro/launch/train.py:72-77``).
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Callable, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.core.secure_agg import mask_generator
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.models import model as model_lib
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.delayed import delayed_init, delayed_update
from repro_torch.optim.tree import leaves, unflatten
from repro_torch.sharding.api import Runtime

OPTIMIZERS = ("adamw", "vfb2_sgd")
SEED = 0          # the parameters, the token stream and the masks


def build_runtime(model_parallel: int, reduced: bool) -> Runtime:
    """q = ``model_parallel`` parties on one device, the plain routes;
    the reference's smaller attention and loss chunks for a reduced
    config."""
    kw = dict(attn_chunk=128, loss_chunk=64) if reduced else {}
    return Runtime(model_size=model_parallel, scan_impl="reference",
                   attn_impl="reference", **kw)


def make_optimizer(optimizer: str, params, lr: float, tau: int = 4):
    """(initial state, update function) of ``optimizer``."""
    if optimizer == "adamw":
        return adamw_init(params), functools.partial(adamw_update, lr=lr)
    if optimizer == "vfb2_sgd":
        return (delayed_init(params, tau),
                functools.partial(delayed_update, lr=lr))
    raise ValueError(f"optimizer must be one of {OPTIMIZERS}; got "
                     f"{optimizer!r}")


def loss_and_grads(rt: Runtime, cfg: ArchConfig, params, batch,
                   gen: torch.Generator):
    """(loss, gradient tree) of ``train_loss`` at ``params``, every leaf
    differentiated (``torch.autograd.grad``)."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss = model_lib.train_loss(rt, cfg, unflatten(params, iter(flat)),
                                batch, gen)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(params, iter(grads))


def train_step(rt: Runtime, cfg: ArchConfig, params, opt, batch,
               gen: torch.Generator, update: Callable):
    """One training step: the loss and gradients, then ``update(params,
    grads, opt)``.  Returns (loss as a 0-d device tensor, new params,
    new optimiser state)."""
    loss, grads = loss_and_grads(rt, cfg, params, batch, gen)
    params, opt = update(params, grads, opt)
    return loss, params, opt


def to_device_batch(batch, dev: torch.device, cfg: ArchConfig):
    """A numpy batch {"tokens", "labels"} as int64 tensors on ``dev``;
    for ``cfg``'s encoder-decoder zero bf16 "frames" (B, enc_seq,
    2·d_model) beside them, for its VLM zero bf16 "patches" (B,
    n_patches, d_patch)."""
    out = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
           for k, v in batch.items()}
    b = out["tokens"].shape[0]
    if cfg.enc_dec:
        out["frames"] = torch.zeros((b, cfg.enc_seq, 2 * cfg.d_model),
                                    dtype=torch.bfloat16, device=dev)
    if cfg.arch_type == "vlm":
        out["patches"] = torch.zeros((b, cfg.n_patches, cfg.d_patch),
                                     dtype=torch.bfloat16, device=dev)
    return out


def train(arch: str, steps: int, batch: int, seq: int, lr: float,
          optimizer: str = "adamw", tau: int = 4, reduced: bool = True,
          ckpt_dir: Optional[str] = None, log_every: int = 10,
          model_parallel: int = 1, *, device="cuda") -> List[float]:
    """Train ``arch`` for ``steps`` steps of (batch, seq) synthetic tokens
    from ``init_params(cfg, SEED)``; returns the losses.  The masks of
    step i come from a generator seeded from (SEED, i).  The final
    {"params": ...} is saved to ``ckpt_dir`` (step ``steps``) where
    given."""
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    model_lib.layer_kinds(cfg)
    dev = resolve_device(device)
    rt = build_runtime(model_parallel, reduced)
    params = model_lib.init_params(cfg, SEED, device=dev)
    opt, update = make_optimizer(optimizer, params, lr, tau)
    losses = []
    t0 = time.time()
    data = synthetic_token_batches(cfg.vocab, batch, seq, steps, seed=SEED)
    for i, b in enumerate(data):
        loss, params, opt = train_step(rt, cfg, params, opt,
                                       to_device_batch(b, dev, cfg),
                                       mask_generator(SEED, i, device=dev),
                                       update)
        losses.append(float(loss))
        if i % log_every == 0:
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    if ckpt_dir:
        save_checkpoint(ckpt_dir, {"params": params}, step=steps)
        print("checkpoint saved to", ckpt_dir)
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=OPTIMIZERS)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="full (production) config instead of reduced")
    ap.add_argument("--ckpt")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    losses = train(a.arch, a.steps, a.batch, a.seq, a.lr, a.optimizer,
                   a.tau, reduced=not a.full, ckpt_dir=a.ckpt,
                   model_parallel=a.model_parallel, device=a.device)
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
