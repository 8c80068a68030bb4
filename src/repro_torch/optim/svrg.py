"""SVRG at framework scale: epoch snapshots and the variance-reduced
direction (the port of ``repro.optim.svrg``).

The snapshot's full gradient is estimated on a large reference batch at
the start of each outer loop; inner steps use v = g_i(w) − g_i(w̃) + μ̃.
"""
from __future__ import annotations

from repro_torch.optim.tree import tree_map


def svrg_snapshot(params, ref_grad):
    """{"w_snap": a detached copy of ``params``, "mu": ``ref_grad``}."""
    return {"w_snap": tree_map(lambda x: x.detach().clone(), params),
            "mu": ref_grad}


def svrg_direction(g_now, g_snap, snapshot):
    """v = g_now − g_snap + μ̃, leaf by leaf."""
    return tree_map(lambda a, b, m: a - b + m, g_now, g_snap,
                    snapshot["mu"])
