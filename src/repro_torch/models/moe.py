"""Mixture of experts with expert-parallel dispatch over the parties (the
port of ``repro.models.moe``).

Party ℓ of q owns experts [ℓ·E/q, (ℓ+1)·E/q).  An MoE layer routes each
token to its top-k experts (softmax over the router's f32 logits, the k
largest probabilities renormalised), puts each expert's assignments into
a capacity bucket of C rows (positions in token order, GShard-style: an
assignment past the C-th of its expert is dropped), runs every bucket
through its expert's SwiGLU and adds the results back, gate-weighted, in
token order.  The auxiliary terms are the switch load-balance loss
E·Σ_e density_e·mean prob_e and the router z-loss mean(logsumexp²).

The q parties are a leading tensor dimension on one device (ROADMAP's
party axis rule), and ``apply_moe_sharded`` keeps the reference's two
dispatch modes (``Runtime.moe_dispatch``):

* ``"replicated"``: every party routes the whole token pool.  Within an
  expert the bucket positions do not depend on which other experts are
  local, so the (E, C, D) buckets are built once and read as q parties'
  (E/q, C, D) slices; each party's combine is its own f32 sum cast to
  the activations' dtype, and the reference's ``psum`` of those partials
  is a sum over the party dimension.
* ``"alltoall"``: party ℓ routes token slice ℓ (T/q tokens) with the
  slice's own capacity and builds buckets for all E experts; the two
  ``all_to_all`` exchanges are a permute between (q_src, E, C, D) and
  the experts' (E, q·C, D), and the final ``psum`` of disjoint slices is
  their concatenation.  The auxiliary terms are party 0's slice's, as
  the reference returns them (its ``out_specs=P()`` takes shard 0's
  values without a mean; ROADMAP C.R5).  Where T does not split into q
  slices, or q = 1, it falls back to ``"replicated"``, as the reference
  does.

Every step has a static shape: the bucket counts are a scatter-add of
fixed size (``torch.bincount`` would synchronise with the host), the
buckets are gathered (each slot reads the assignment that fills it, so
no float atomics), and nothing is read back to the host.  The expert
FFN is a batched matmul, as the reference's einsum outside any Pallas
kernel is.  The dtypes follow the reference: buckets in the activations'
dtype, the f32 expert weights cast to it at each call, the combine in
f32 cast back per party.  The top-k choice takes the lower expert first
among equal probabilities, as ``jax.lax.top_k`` does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import normal_init, silu
from repro_torch.sharding.api import MOE_DISPATCHES, Runtime


def init_moe(gen: torch.Generator, d_model: int, d_expert: int,
             n_experts: int, *, lead=()) -> Dict[str, torch.Tensor]:
    """The router (D, E) and the experts' SwiGLU weights (E, D, F),
    (E, D, F), (E, F, D), with ``lead`` prepended (a leading layer axis),
    drawn from ``gen`` on its device."""
    lead = tuple(lead)
    return {"router": normal_init(gen, lead + (d_model, n_experts)),
            "w_gate": normal_init(gen, lead + (n_experts, d_model,
                                               d_expert)),
            "w_up": normal_init(gen, lead + (n_experts, d_model, d_expert)),
            "w_down": normal_init(gen, lead + (n_experts, d_expert,
                                               d_model))}


def capacity(capacity_factor: float, top_k: int, t: int, e: int) -> int:
    """Rows a bucket holds for ``t`` tokens over ``e`` experts (the
    reference's expression, evaluated the same way)."""
    return max(8, min(int(capacity_factor * top_k * t / e), t))


def _route(router: torch.Tensor, xt: torch.Tensor, top_k: int):
    """xt (..., T, D) → (sel (..., T, k) int64, gates (..., T, k) f32,
    aux {"lb_loss", "z_loss"} each (...,))."""
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower expert first among equal
    # probabilities, as jax.lax.top_k does (torch.topk leaves it open)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, sel = vals[..., :top_k], idx[..., :top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    e = router.shape[-1]
    first = sel[..., :1] == torch.arange(e, device=sel.device)
    density = first.float().mean(-2)
    density_prob = probs.mean(-2)
    lb_loss = e * (density * density_prob).sum(-1)
    z_loss = torch.logsumexp(logits, dim=-1).square().mean(-1)
    return sel, gate_vals, {"lb_loss": lb_loss, "z_loss": z_loss}


def _build_buckets(xt: torch.Tensor, sel: torch.Tensor, e_lo: int,
                   e_loc: int, cap: int):
    """Capacity buckets of experts [e_lo, e_lo + e_loc) for G token pools
    at once.  xt (G, T, D), sel (G, T, k).  Returns (buf (G, E_loc, C, D)
    in xt's dtype, meta), meta = (each assignment's local expert, its
    bucket position, kept, local), each (G, T·k) in token order."""
    g, t, d = xt.shape
    top_k = sel.shape[-1]
    n = t * top_k
    dev = xt.device
    local = sel.reshape(g, n) - e_lo
    is_local = (local >= 0) & (local < e_loc)
    # sort assignments by local expert; the others sort to the end
    sort_key = torch.where(is_local, local, e_loc)
    order = torch.argsort(sort_key, dim=-1, stable=True)
    counts = torch.zeros((g, e_loc + 1), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, sort_key, torch.ones_like(sort_key))
    starts = counts.cumsum(1) - counts
    ar = torch.arange(n, device=dev).expand(g, n)
    rank = torch.empty_like(order).scatter_(1, order, ar)
    pos = rank - starts.gather(1, sort_key)      # position in its bucket
    keep = is_local & (pos < cap)
    # slot (e, c) holds sorted assignment starts[e] + c while c < counts[e]
    c = torch.arange(cap, device=dev)
    src = (starts[:, :e_loc, None] + c).clamp(max=n - 1).reshape(g, -1)
    filled = (c < counts[:, :e_loc, None]).reshape(g, -1, 1)
    tok = order.gather(1, src) // top_k \
        + t * torch.arange(g, device=dev)[:, None]
    rows = xt.reshape(g * t, d)[tok.reshape(-1)].view(g, -1, d)
    buf = torch.where(filled, rows, 0).view(g, e_loc, cap, d)
    return buf, (sort_key, pos, keep, is_local)


def _expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU on its bucket: buf (E, C, D) → (E, C, D), the
    f32 weights cast to buf's dtype."""
    g = torch.bmm(buf, w_gate.to(buf.dtype))
    u = torch.bmm(buf, w_up.to(buf.dtype))
    return torch.bmm(silu(g) * u, w_down.to(buf.dtype))


def _combine_buckets(y: torch.Tensor, meta, gate_vals: torch.Tensor,
                     parties: int = 1) -> torch.Tensor:
    """The gate-weighted sum of each token's kept assignments in token
    order.  y (G, E_loc, C, D); gate_vals (G, T, k).  Returns (parties,
    G, T, D) in y's dtype: party ℓ's partial sums its own E_loc/parties
    experts, in f32, cast to y's dtype."""
    e_tok, pos, keep, is_local = meta
    g, e_loc, cap, d = y.shape
    t, top_k = gate_vals.shape[-2:]
    slot = e_tok.clamp(max=e_loc - 1) * cap + pos.clamp(0, cap - 1) \
        + e_loc * cap * torch.arange(g, device=y.device)[:, None]
    y_assign = y.reshape(-1, d)[slot.reshape(-1)].view(g, t * top_k, d)
    y_assign = torch.where(keep[..., None], y_assign, 0)
    gates = torch.where(is_local, gate_vals.reshape(g, -1), 0)
    owner = e_tok // (e_loc // parties)
    gates = torch.where(owner == torch.arange(parties, device=y.device)
                        .view(-1, 1, 1), gates, 0)     # (parties, G, T·k)
    return torch.einsum("gtkd,pgtk->pgtd",
                        y_assign.view(g, t, top_k, d).float(),
                        gates.view(parties, g, t, top_k)).to(y.dtype)


def _dispatch_local(xt, sel, gate_vals, e_lo, e_loc, cap, w_gate, w_up,
                    w_down, parties: int = 1):
    """Dispatch, compute and combine for experts [e_lo, e_lo + e_loc)
    only (``w_*`` are those experts' weights), on one token pool: xt
    (1, T, D); returns (parties, 1, T, D) as ``_combine_buckets``."""
    buf, meta = _build_buckets(xt, sel, e_lo, e_loc, cap)
    y = _expert_ffn(buf[0], w_gate, w_up, w_down)[None]
    return _combine_buckets(y, meta, gate_vals, parties)


def apply_moe(params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The one-party layer (the oracle of the tests, and q = 1).
    x (B, S, D) → (out (B, S, D) in x's dtype, aux of 0-d f32)."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    t = b * s
    xt = x.reshape(1, t, d)
    sel, gate_vals, aux = _route(params["router"], xt, top_k)
    out = _dispatch_local(xt, sel, gate_vals, 0, e,
                          capacity(capacity_factor, top_k, t, e),
                          params["w_gate"], params["w_up"], params["w_down"])
    return out.view(b, s, d), {k: v[0] for k, v in aux.items()}


def apply_moe_sharded(rt: Runtime, params, x: torch.Tensor, *, top_k: int,
                      capacity_factor: float = 1.25,
                      dispatch: Optional[str] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The layer over ``rt.model_size`` = q parties, each owning E/q
    experts (see the module docstring).  ``dispatch``: ``"replicated"``
    or ``"alltoall"``; ``None`` takes ``rt.moe_dispatch``.  x (B, S, D)
    → (out (B, S, D) in x's dtype, aux of 0-d f32)."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    q = rt.model_size
    if e % q:
        raise ValueError(f"{e} experts do not split into {q} parties")
    dispatch = dispatch or rt.moe_dispatch
    if dispatch not in MOE_DISPATCHES:
        raise ValueError(f"dispatch must be one of {MOE_DISPATCHES}; got "
                         f"{dispatch!r}")
    w = (params["w_gate"], params["w_up"], params["w_down"])
    t = b * s
    if dispatch == "alltoall" and t % q == 0 and q > 1:
        t_q = t // q
        xs = x.reshape(q, t_q, d)                 # party ℓ's token slice
        sel, gate_vals, aux = _route(params["router"], xs, top_k)
        cap = capacity(capacity_factor, top_k, t_q, e)
        buf, meta = _build_buckets(xs, sel, 0, e, cap)   # (q_src, E, C, D)
        # to the experts' parties: expert e's rows from every source slice
        # in source order, (E, q·C, D) (party p holds E/q of them)
        buf = buf.transpose(0, 1).reshape(e, q * cap, d)
        y = _expert_ffn(buf, *w)
        # the return trip to each source slice: (q_src, E, C, D)
        y = y.view(e, q, cap, d).transpose(0, 1)
        out = _combine_buckets(y, meta, gate_vals)[0]    # the slices
        return out.reshape(b, s, d), {k: v[0] for k, v in aux.items()}
    xt = x.reshape(1, t, d)
    sel, gate_vals, aux = _route(params["router"], xt, top_k)
    cap = capacity(capacity_factor, top_k, t, e)
    # every party's (E/q, C, D) buckets, stacked as (E, C, D)
    parts = _dispatch_local(xt, sel, gate_vals, 0, e, cap, *w, parties=q)
    return parts.sum(0).view(b, s, d), {k: v[0] for k, v in aux.items()}
