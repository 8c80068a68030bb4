"""Backward Updating Mechanism (BUM) as an autograd function (the port of
``repro.core.bum``).

``secure_vfl_reduce`` is the paper's data path in one function over a
party-stacked partial ``(q, ...)``:

* forward = Algorithm 1: the masked sum over the party dimension
  (``two_tree``: ``secure_agg.secure_psum``, with ``schedule_faithful``;
  ``ring_masks``: ``secure_agg.secure_psum_ring``);
* backward = BUM: the cotangent ϑ of the aggregate goes back to every
  party unchanged, so the gradient of the partial is ϑ expanded over q.
  The reference's ``shard_map`` form receives ϑ split 1/q per shard and
  psums it back (``repro/core/bum.py:50-63``); here the party axis is a
  tensor dimension, so there is no split to undo.

The masks come from the generator the caller passes, inside the forward,
so they are not part of the autograd graph (masks cancel and carry no
gradient, as in the protocol).
"""
from __future__ import annotations

import torch

from repro_torch.core import secure_agg

MODES = ("two_tree", "ring_masks")


class _SecureVflReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, partial, gen, mask_scale, schedule_faithful, mode):
        ctx.parties, ctx.dtype = partial.shape[0], partial.dtype
        if mode == "ring_masks":       # beyond-paper single-collective form
            return secure_agg.secure_psum_ring(partial, gen, mask_scale)
        return secure_agg.secure_psum(partial, gen, mask_scale,
                                      schedule_faithful)

    @staticmethod
    def backward(ctx, theta):
        theta = theta.to(ctx.dtype)
        return (theta.unsqueeze(0).expand(ctx.parties, *theta.shape), None,
                None, None, None)


def secure_vfl_reduce(partial: torch.Tensor, gen: torch.Generator,
                      mask_scale: float = 1.0,
                      schedule_faithful: bool = False,
                      mode: str = "two_tree") -> torch.Tensor:
    """Securely sum the party-stacked ``partial`` (q, ...) over its first
    dimension; its gradient is BUM's (every party receives ϑ).  Returns
    the aggregate, shaped ``partial.shape[1:]``, in partial's dtype."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    return _SecureVflReduce.apply(partial, gen, float(mask_scale),
                                  bool(schedule_faithful), mode)


def host_theta(loss_grad_fn, agg, y):
    """ϑ = ∂L(wᵀx, y)/∂(wᵀx), computed only where the labels live (the
    active party)."""
    return loss_grad_fn(agg, y)
