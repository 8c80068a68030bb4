"""VFB²'s bounded-staleness optimiser at framework scale (the port of
``repro.optim.delayed``).

The SPMD form of BAPA: a ring of the last τ + 1 gradients of every
parameter leaf is carried in the optimiser state, and each leaf is
updated with the gradient of step t − d, d ≤ τ.  A leaf's delay is static:
``md5(path) % (τ + 1)``, with ``path`` the leaf's ``jax.tree_util.keystr``
(``"['stack']['ssm']['w_in']"``; ``optim.tree``), so every leaf gets the
reference's delay.  The run is an admissible trajectory of the paper's
asynchronous model (Assumption 3).  The ring slot is ``step % (τ+1)`` and
the read index ``max(step − d, 0) % (τ+1)``, both on the device (no host
read of the step).
"""
from __future__ import annotations

import hashlib

import torch

from repro_torch.optim.tree import (leaves, leaves_with_path, tree_map,
                                    unflatten)


def _leaf_delay(path: str, tau: int) -> int:
    if tau == 0:
        return 0
    h = int(hashlib.md5(path.encode()).hexdigest()[:8], 16)
    return h % (tau + 1)


def leaf_delays(params, tau: int):
    """{key path: delay} of every leaf of ``params``."""
    return {path: _leaf_delay(path, tau)
            for path, _ in leaves_with_path(params)}


def delayed_init(params, tau: int):
    """A zero ring (τ + 1, *shape) per leaf in its dtype, a 0-d int32
    step and τ."""
    first = leaves(params)[0]
    buf = tree_map(lambda p: torch.zeros((tau + 1,) + tuple(p.shape),
                                         dtype=p.dtype, device=p.device),
                   params)
    return {"buf": buf,
            "step": torch.zeros((), dtype=torch.int32, device=first.device),
            "tau": tau}


@torch.no_grad()
def delayed_update(params, grads, state, *, lr=1e-2):
    """SGD with per-leaf stale gradients (paper Alg. 2/3, Eq. 4/5):
    write this step's gradient into the ring at ``step % (τ+1)``, then
    step each leaf with the slot of ``step − d``.  The rings are written
    in place (the state passed in is consumed); the parameters come back
    as new tensors."""
    tau, step = state["tau"], state["step"]
    slot = (step % (tau + 1)).long().view(1)
    new_p = []
    for (path, p), g, buf in zip(leaves_with_path(params), leaves(grads),
                                 leaves(state["buf"])):
        d = _leaf_delay(path, tau)
        buf.index_copy_(0, slot, g.to(buf.dtype).unsqueeze(0))
        eff = ((step - d).clamp(min=0) % (tau + 1)).long().view(1)
        stale = buf.index_select(0, eff)[0]
        new_p.append((p - lr * stale.float()).to(p.dtype))
    return (unflatten(params, iter(new_p)),
            {"buf": state["buf"], "step": step + 1, "tau": tau})
