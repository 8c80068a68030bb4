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

Over a process group (``group=``, one party a member, as the reference's
``shard_map`` over ``P("model")``): the forward is the member's masked
partial and the collectives (``secure_agg.secure_psum_dist``, or
``secure_psum_ring_dist`` with ``gen_prev``, the stream of the party
before), the backward BUM's broadcast: the dominator's member (group
rank 0) sends its ϑ to every member, whose party receives it whole.
"""
from __future__ import annotations

import torch

from repro_torch.core import secure_agg

MODES = ("two_tree", "ring_masks")


class _SecureVflReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, partial, gen, mask_scale, schedule_faithful, mode,
                group, gen_prev):
        ctx.parties, ctx.dtype = partial.shape[0], partial.dtype
        ctx.group = group
        if group is not None:
            if mode == "ring_masks":
                return secure_agg.secure_psum_ring_dist(
                    partial, gen, gen_prev, group, mask_scale)
            return secure_agg.secure_psum_dist(partial, gen, group,
                                               mask_scale, schedule_faithful)
        if mode == "ring_masks":       # beyond-paper single-collective form
            return secure_agg.secure_psum_ring(partial, gen, mask_scale)
        return secure_agg.secure_psum(partial, gen, mask_scale,
                                      schedule_faithful)

    @staticmethod
    def backward(ctx, theta):
        theta = theta.to(ctx.dtype)
        none = (None,) * 6
        if ctx.group is not None:
            import torch.distributed as dist
            theta = theta.clone(memory_format=torch.contiguous_format)
            dist.broadcast(theta, dist.get_global_rank(ctx.group, 0),
                           group=ctx.group)
            return (theta,) + none
        return (theta.unsqueeze(0).expand(ctx.parties, *theta.shape),) + none


def secure_vfl_reduce(partial: torch.Tensor, gen: torch.Generator,
                      mask_scale: float = 1.0,
                      schedule_faithful: bool = False,
                      mode: str = "two_tree", *, group=None,
                      gen_prev=None) -> torch.Tensor:
    """Securely sum the party-stacked ``partial`` (q, ...) over its first
    dimension; its gradient is BUM's (every party receives ϑ).  Returns
    the aggregate, shaped ``partial.shape[1:]``, in partial's dtype.

    With ``group``, ``partial`` is this member's party's value, ``gen``
    its party's stream and ``gen_prev`` (``ring_masks``) the previous
    party's; the aggregate, shaped as ``partial``, is the sum over the
    group, and the gradient is the dominator's ϑ, broadcast."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    if group is not None and mode == "ring_masks" and gen_prev is None:
        raise ValueError("ring_masks over a process group needs gen_prev, "
                         "the previous party's stream")
    return _SecureVflReduce.apply(partial, gen, float(mask_scale),
                                  bool(schedule_faithful), mode, group,
                                  gen_prev)


def host_theta(loss_grad_fn, agg, y):
    """ϑ = ∂L(wᵀx, y)/∂(wᵀx), computed only where the labels live (the
    active party)."""
    return loss_grad_fn(agg, y)
