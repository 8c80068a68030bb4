"""Dependency-free AdamW, the framework-scale default optimiser (the port
of ``repro.optim.adamw``)."""
from __future__ import annotations

import torch

from repro_torch.optim.tree import leaves, tree_map, unflatten


def adamw_init(params):
    """Zero moments (f32, one per leaf) and a 0-d int32 step on the
    parameters' device."""
    first = leaves(params)[0]
    return {
        "mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params),
        "nu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


@torch.no_grad()
def adamw_update(params, grads, state, *, lr=3e-4, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """One AdamW step over every leaf, norms included; returns (new
    params, new state).  The bias corrections use the step count as f32;
    the weight decay is decoupled: p − lr·(m̂/(√n̂ + ε) + wd·p), in the
    reference's order of operations.  The moments are updated in place
    (the state passed in is consumed); the parameters come back as new
    tensors in their dtype."""
    step = state["step"] + 1
    t = step.float()
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    new_p = []
    for p, g, m, n in zip(leaves(params), leaves(grads),
                          leaves(state["mu"]), leaves(state["nu"])):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        n.mul_(b2).add_((1 - b2) * g * g)
        mhat, nhat = m / bc1, n / bc2
        newp = p - lr * (mhat / (torch.sqrt(nhat) + eps) + weight_decay * p)
        new_p.append(newp.to(p.dtype))
    return (unflatten(params, iter(new_p)),
            {"mu": state["mu"], "nu": state["nu"], "step": step})
