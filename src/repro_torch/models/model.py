"""The decoder model with VFB²'s secure frontends (the port of
``repro.models.model``: the SSM family, falcon-mamba; the dense family,
gemma3 / stablelm / granite / internlm2; the MoE family, granite-moe /
qwen3-moe; and the hybrid period stack, jamba).

Parameters are the reference's stacked-layer dict: ``embed`` (V_pad, D),
``final_norm`` (D,) and ``stack``, each block parameter with a leading
layer axis: {``norm1``, ``ssm``} for the SSM family, {``norm1``, ``attn``
{``wq``, ``wk``, ``wv``, ``wo``}, ``norm2``, ``mlp`` {``w_gate``,
``w_up``, ``w_down``}} for the dense family, the same with ``moe``
{``router``, ``w_gate``, ``w_up``, ``w_down``} (``models.moe``) in place
of ``mlp`` for the MoE family.  A period stack (``cfg.period``, jamba's
8 kinds) keeps ``periods`` in place of ``stack``: a list with one stacked
tree per period position, each with a leading axis of n_per =
n_layers / len(period), its block a mixer ({``norm1``, ``ssm``} or
{``norm1``, ``attn``}) and a feed-forward ({``norm2``, ``mlp``} or
{``norm2``, ``moe``}) as the position's kind (``"ssm_moe"``,
``"attn_mlp"``, ...) says.  Layer i·len(period) + pos is
``periods[pos][i]``: the stack runs period by period, the positions in
order within each.  The stack runs as a loop over its layers; an MoE
layer's feed-forward is ``moe.apply_moe_sharded`` over the q parties
under ``Runtime.moe_dispatch``, and its auxiliary terms (load balance,
router z-loss) are summed over the layers into ``train_loss``.  Tokens enter through the paper's secure vocabulary
embedding (``vfl.embed``) and leave through the party-sharded heads
(``vfl.heads``: the loss, the greedy token); the q parties are
``Runtime.model_size``.

Modes: ``train_loss`` (the mean next-token cross-entropy through the
party-sharded ``vocab_parallel_loss``, differentiable on the plain routes),
``prefill`` (the next token after a prompt, and the dense and MoE
families' bf16 KV cache (L, B, S, Hkv, dh)) and ``decode_step`` (one token).  The
dense decode step writes the new K/V in place into the cache at ``pos``
and attends over the cache viewed as q party shards of S/q positions,
whose partial results are merged by log-sum-exp (Algorithm 1's partial
aggregation, unmasked at serving time).  ``Runtime.attn_impl`` routes the
attention: ``"kernel"`` through ``ops.flash_attention`` (prefill) and
``ops.decode_attention`` (all shards in one launch), ``"reference"``
through the plain ``chunked_attention`` and ``local_decode_attention``.
The kernel routes are forward-only (``kernels.ops``): ``train_loss``
under autograd runs on ``scan_impl="reference"`` (the sequential scan)
and ``attn_impl="reference"`` and raises on a kernel route; under
``torch.no_grad()`` it runs either.
Each layer's window comes from ``layer_windows``: gemma3's local layers
see the last 1,024 positions, its every 6th layer (and every layer of
the other dense configs) all of them.

As in the reference, ``prefill`` collects no state for the SSM family
and returns ``None`` as its cache (``repro/models/model.py:508``):
decoding starts from ``init_cache``'s zero state, so the tokens after the
first do not see the prompt (ROADMAP C.R3, mirrored so the port can be
held against the reference).  The same holds for a period stack, for
every layer (C.R6): its prefill returns ``None``, so decoding starts from
zero SSM states and a zero KV cache, and the attention layers attend
over ``prompt_len`` zero keys with zero values, which still count in
their softmax.  A period stack's decode cache is the reference's list of
one entry per period position (leading axis n_per): {``"k"``, ``"v"``}
for an attention position, {``"conv"``, ``"h"``} for an SSM position;
its attention sees every cached position up to ``pos`` (no window).

Encoder-decoder (cross attention) and the VLM frontend (ROADMAP A15d)
raise ``NotImplementedError`` naming ROADMAP A15, as does a ``Runtime``
that sets the reference's ``remat``, ``unroll_layers`` or
``seq_parallel_norms`` (A15e).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (ACT_DTYPE, apply_mlp, init_mlp,
                                       normal_init, rms_norm)
from repro_torch.sharding.api import Runtime
from repro_torch.vfl.embed import secure_vocab_embed
from repro_torch.vfl.heads import vocab_parallel_greedy, vocab_parallel_loss

CACHE_DTYPE = torch.bfloat16
# the MoE terms' weights in train_loss (0 terms for the SSM and dense
# families, which have no router)
AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-3


def _unported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet: the port's LM stack has the SSM, "
        "dense, MoE and hybrid (period) families (training, prefill and "
        "greedy decode) only; cross attention and the VLM frontend are "
        "ROADMAP A15d")


def layer_kinds(cfg: ArchConfig):
    """Per-layer kind sequence of the decoder stack: a period stack's
    period repeated n_layers / len(period) times."""
    if cfg.arch_type not in ("ssm", "dense", "moe", "hybrid") or cfg.enc_dec:
        _unported(f"{cfg.name} ({cfg.arch_type} layers)")
    if cfg.arch_type == "ssm":
        return ("ssm",) * cfg.n_layers
    if cfg.period is not None:
        if cfg.n_layers % len(cfg.period):
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a "
                             f"whole number of {len(cfg.period)}-layer "
                             "periods")
        return tuple(cfg.period) * (cfg.n_layers // len(cfg.period))
    ffn = "moe" if cfg.moe is not None else "mlp"
    return (f"attn_{ffn}",) * cfg.n_layers


def layer_windows(cfg: ArchConfig, seq_len: int) -> List[int]:
    """Per-layer attention window (``seq_len`` ⇒ in effect global)."""
    win = [seq_len] * cfg.n_layers
    if cfg.window:
        win = [cfg.window] * cfg.n_layers
        if cfg.global_every:
            for i in range(cfg.global_every - 1, cfg.n_layers,
                           cfg.global_every):
                win[i] = seq_len
    return win


def _init_block(gen: torch.Generator, cfg: ArchConfig, kind: str, n: int):
    """``n`` stacked blocks of ``kind`` (leading axis n), each tensor
    drawn whole: ``norm1`` and the mixer (``ssm``, or ``attn`` for a kind
    starting "attn"), then, for a kind ending "mlp" or "moe", ``norm2``
    and that feed-forward (``repro/models/model.py:84-103``)."""
    d, dev = cfg.d_model, gen.device
    block = {"norm1": torch.zeros((n, d), device=dev)}
    if kind.startswith("attn"):
        hd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv * cfg.head_dim
        block["attn"] = {
            "wq": normal_init(gen, (n, d, hd)),
            "wk": normal_init(gen, (n, d, kvd)),
            "wv": normal_init(gen, (n, d, kvd)),
            "wo": normal_init(gen, (n, hd, d),
                              scale=0.02 / math.sqrt(2 * cfg.n_layers))}
    else:
        s = cfg.ssm
        block["ssm"] = ssm_lib.init_ssm(gen, d, s.d_state, s.d_conv,
                                        s.expand, lead=(n,))
    if kind.endswith(("mlp", "moe")):
        block["norm2"] = torch.zeros((n, d), device=dev)
    if kind.endswith("mlp"):
        block["mlp"] = init_mlp(gen, d, cfg.d_ff, lead=(n,))
    elif kind.endswith("moe"):
        m = cfg.moe
        block["moe"] = moe_lib.init_moe(gen, d, m.d_expert, m.n_experts,
                                        lead=(n,))
    return block


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device="cuda") -> Dict[str, Any]:
    """Random parameters from a generator on ``device`` seeded with
    ``seed``, each stacked tensor drawn whole (no per-layer copies): the
    uniform ``stack``, or a period stack's ``periods``, one stacked tree
    per period position."""
    kinds = layer_kinds(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    d = cfg.d_model
    params = {"embed": normal_init(gen, (cfg.padded_vocab, d)),
              "final_norm": torch.zeros((d,), device=dev)}
    if cfg.period is None:
        params["stack"] = _init_block(gen, cfg, kinds[0], cfg.n_layers)
    else:
        n_per = cfg.n_layers // len(cfg.period)
        params["periods"] = [_init_block(gen, cfg, kind, n_per)
                             for kind in cfg.period]
    return params


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stacks(cfg: ArchConfig, tree):
    """A params or cache tree's stacks, one per period position (the
    uniform stack is a period of one kind), with their kinds and the
    layers each holds."""
    if cfg.period is None:
        return [tree], layer_kinds(cfg)[:1], cfg.n_layers
    return tree, tuple(cfg.period), cfg.n_layers // len(cfg.period)


def _blocks(cfg: ArchConfig, params) -> Iterator[Tuple[int, str, Any]]:
    """(layer, kind, block parameters) of every layer in the stack's
    order: period by period, the positions in order within each (layer
    i·len(period) + pos is ``periods[pos][i]``)."""
    stacks, kinds, n = _stacks(cfg, params["stack"] if cfg.period is None
                               else params["periods"])
    for i in range(n):
        for pos, kind in enumerate(kinds):
            yield i * len(kinds) + pos, kind, _layer(stacks[pos], i)


def _embed_tokens(rt: Runtime, cfg: ArchConfig, params, tokens,
                  gen: torch.Generator):
    if rt.secure_embed:
        return secure_vocab_embed(rt, params["embed"], tokens, gen)
    return params["embed"][tokens].to(ACT_DTYPE)


def _prepare_inputs(rt: Runtime, cfg: ArchConfig, params, batch,
                    gen: torch.Generator):
    """Embed the tokens; returns (x, enc_out, n_prefix) as the reference
    does (no encoder and no prefix in the SSM and dense families)."""
    if cfg.enc_dec or cfg.arch_type == "vlm":
        _unported(f"{cfg.name}'s {cfg.arch_type} frontend")
    return _embed_tokens(rt, cfg, params, batch["tokens"], gen), None, 0


# ---------------------------------------------------------------------------
# forward blocks (prefill)
# ---------------------------------------------------------------------------

def _pick_chunk(s: int, target: int) -> int:
    """The largest query chunk ≤ ``target`` that divides ``s``."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _apply_attention(rt: Runtime, cfg: ArchConfig, p, x, window: int):
    """Causal self attention over x (B, S, D) with rotary positions 0..S−1
    and the layer's ``window``.  Returns (out (B, S, D), (k, v)), k and v
    (B, S, Hkv, dh) for the cache."""
    b, s, _ = x.shape
    dh, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv
    q = (x @ p["wq"].to(x.dtype)).view(b, s, h, dh)
    k = (x @ p["wk"].to(x.dtype)).view(b, s, hkv, dh)
    v = (x @ p["wv"].to(x.dtype)).view(b, s, hkv, dh)
    positions = torch.arange(s, device=x.device)[None]
    q = attn_lib.apply_rope_positions(q, positions, cfg.rope_theta)
    k = attn_lib.apply_rope_positions(k, positions, cfg.rope_theta)
    if rt.attn_impl == "kernel":
        # (B, S, H, dh) read as (B, H, S, dh) views, written back in place
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                window=window).transpose(1, 2)
    else:
        o = attn_lib.chunked_attention(q, k, v, causal=True, window=window,
                                       chunk=_pick_chunk(s, rt.attn_chunk))
    return o.reshape(b, s, h * dh) @ p["wo"].to(x.dtype), (k, v)


def _no_aux():
    return {"lb_loss": 0.0, "z_loss": 0.0}


def _apply_ffn(rt: Runtime, cfg: ArchConfig, p, x):
    """The block's feed-forward on the residual stream x (B, S, D).
    Returns (x, aux): the MoE layer's {"lb_loss", "z_loss"} (0-d f32),
    0 for an MLP layer."""
    if "mlp" in p:
        return x + apply_mlp(p["mlp"], rms_norm(x, p["norm2"])), _no_aux()
    if "moe" in p:
        out, aux = moe_lib.apply_moe_sharded(
            rt, p["moe"], rms_norm(x, p["norm2"]), top_k=cfg.moe.top_k,
            capacity_factor=cfg.moe.capacity_factor,
            dispatch=rt.moe_dispatch)
        return x + out, aux
    return x, _no_aux()


def _block_fwd(rt: Runtime, cfg: ArchConfig, kind: str, p, x, window: int,
               kv_out=None):
    """One decoder block over a sequence (prefill): the mixer (attention
    for a kind starting "attn", else the SSM), then the block's
    feed-forward, if it has one.  ``kv_out``: an attention layer's
    {"k", "v"} cache slices (B, S, Hkv, dh) to fill, or None.  Returns
    (x, aux) as ``_apply_ffn``."""
    h = rms_norm(x, p["norm1"])
    if kind.startswith("attn"):
        o, (k, v) = _apply_attention(rt, cfg, p["attn"], h, window)
        if kv_out is not None:
            kv_out["k"].copy_(k)
            kv_out["v"].copy_(v)
    else:
        o = ssm_lib.apply_ssm(p["ssm"], h, scan_impl=rt.scan_impl)
    return _apply_ffn(rt, cfg, p, x + o)


def _backbone(rt: Runtime, cfg: ArchConfig, params, x, *, kv=None,
              aux=None):
    """The stack, layer by layer, and the final norm: (B, S, D) → the
    normed hidden states (B, S, D).  Each layer's window is
    ``layer_windows(cfg, S)``'s (every layer of a period stack: S);
    ``kv``, where given, is a uniform stack's {"k", "v"} cache (L, B, S,
    Hkv, dh) the layers fill; ``aux``, where given, is a {"lb_loss",
    "z_loss"} dict each layer's terms are added to."""
    windows = layer_windows(cfg, x.shape[1])
    for i, kind, p in _blocks(cfg, params):
        x, layer_aux = _block_fwd(rt, cfg, kind, p, x, windows[i],
                                  None if kv is None else _layer(kv, i))
        if aux is not None:
            for k in aux:
                aux[k] = aux[k] + layer_aux[k]
    return rms_norm(x, params["final_norm"])


def train_loss(rt: Runtime, cfg: ArchConfig, params, batch,
               gen: torch.Generator) -> torch.Tensor:
    """Mean next-token cross-entropy (0-d f32) of ``batch`` = {"tokens",
    "labels"}, each (B, S) (``repro/models/model.py:491-501``): the secure
    embedding (masks from ``gen``), the stack without a KV cache, the
    final norm and ``vocab_parallel_loss`` on the tied table, plus the MoE
    auxiliary terms summed over the layers (0 for the SSM and dense
    families)."""
    x, _, n_prefix = _prepare_inputs(rt, cfg, params, batch, gen)
    aux = _no_aux()
    h = _backbone(rt, cfg, params, x, aux=aux)
    if n_prefix:
        h = h[:, n_prefix:]
    loss = vocab_parallel_loss(rt, params["embed"], h, batch["labels"],
                               cfg.padded_vocab)
    return loss + AUX_LOSS_WEIGHT * aux["lb_loss"] \
        + Z_LOSS_WEIGHT * aux["z_loss"]


def prefill(rt: Runtime, cfg: ArchConfig, params, batch,
            gen: torch.Generator):
    """Forward over the prompt ``batch["tokens"]`` (B, S); returns
    (next_token (B,), cache).  The dense and MoE families' cache is
    {"k", "v"},
    each (L, B, S, Hkv, dh) bf16 with rotary positions applied to k; the
    SSM family's and a period stack's is ``None``, as in the reference
    (C.R3, C.R6)."""
    x, _, _ = _prepare_inputs(rt, cfg, params, batch, gen)
    kv = None
    if cfg.period is None and layer_kinds(cfg)[0] != "ssm":
        shape = (cfg.n_layers,) + tuple(x.shape[:2]) \
            + (cfg.n_kv, cfg.head_dim)
        kv = {n: torch.empty(shape, dtype=CACHE_DTYPE, device=x.device)
              for n in ("k", "v")}
    h = _backbone(rt, cfg, params, x, kv=kv)
    return vocab_parallel_greedy(rt, params["embed"], h[:, -1]), kv


# ---------------------------------------------------------------------------
# decode (one token against the party-sharded cache)
# ---------------------------------------------------------------------------

def init_cache(rt: Runtime, cfg: ArchConfig, batch: int, seq_len: int, *,
               device="cuda"):
    """The zero decode state.  Dense: the KV cache {"k", "v"}, each
    (L, B, seq_len, Hkv, dh) bf16, its sequence axis split over the q
    parties (so q must divide seq_len to decode).  SSM: conv (L, B, K−1,
    Ci) bf16 and h (L, B, Ci, N) f32 (``seq_len`` does not size an SSM
    state).  A period stack: the list of one such entry per period
    position, each with leading axis n_per in place of L."""
    _, kinds, n = _stacks(cfg, None)
    dev = resolve_device(device)

    def entry(kind):
        if kind.startswith("attn"):
            shape = (n, batch, seq_len, cfg.n_kv, cfg.head_dim)
            return {name: torch.zeros(shape, dtype=CACHE_DTYPE, device=dev)
                    for name in ("k", "v")}
        s = cfg.ssm
        return ssm_lib.init_ssm_cache(batch, cfg.d_model, s.d_state,
                                      s.d_conv, s.expand, lead=(n,),
                                      device=dev)

    cache = [entry(kind) for kind in kinds]
    return cache if cfg.period is not None else cache[0]


def _decode_attention(rt: Runtime, cfg: ArchConfig, p, x, kc, vc, pos: int,
                      pos_t: torch.Tensor, window: int):
    """One token's attention against the layer's cache (B, S, Hkv, dh),
    seen as q party shards of S/q positions.  x: (B, D); ``pos_t`` is
    ``pos`` as a 0-d int32 tensor on x's device.  The new K/V are written
    into the cache at ``pos`` in place (on one device every party's write
    lands in the one shard that owns ``pos``); the shards' partials are
    merged by log-sum-exp.  Returns the attention output (B, D)."""
    b = x.shape[0]
    dh, h, hkv, q_par = cfg.head_dim, cfg.n_heads, cfg.n_kv, rt.model_size
    s = kc.shape[1]
    if s % q_par:
        raise ValueError(f"the cache's {s} positions do not split into "
                         f"{q_par} party shards")
    at = pos_t.view(1, 1)
    q = attn_lib.apply_rope_positions(
        (x @ p["wq"].to(x.dtype)).view(b, 1, h, dh), at, cfg.rope_theta)[:, 0]
    k_new = attn_lib.apply_rope_positions(
        (x @ p["wk"].to(x.dtype)).view(b, 1, hkv, dh), at,
        cfg.rope_theta)[:, 0]
    kc[:, pos] = k_new
    vc[:, pos] = (x @ p["wv"].to(x.dtype)).view(b, hkv, dh)
    if rt.attn_impl == "kernel":
        o, m, l = ops.decode_attention(q, kc, vc, pos_t, 0, window,
                                       shards=q_par)
    else:
        o, m, l = attn_lib.shard_partials(q, kc, vc, pos, q_par,
                                          window=window)
    o = attn_lib.merge_partial_attention(o, m, l).to(x.dtype)
    return o.reshape(b, h * dh) @ p["wo"].to(x.dtype)


def _block_decode(rt: Runtime, cfg: ArchConfig, kind: str, p, x, cache,
                  pos: int, pos_t, window: int):
    """One block, one token: the mixer, then the block's feed-forward, if
    it has one.  x: (B, D).  Returns (x, new_cache): a new SSM state, or
    the layer's KV cache itself, written in place."""
    h = rms_norm(x, p["norm1"])
    if kind.startswith("attn"):
        o = _decode_attention(rt, cfg, p["attn"], h, cache["k"], cache["v"],
                              pos, pos_t, window)
        new = cache
    else:
        o, new = ssm_lib.apply_ssm_decode(p["ssm"], h, cache)
    x, _ = _apply_ffn(rt, cfg, p, (x + o)[:, None])   # decode drops the aux
    return x[:, 0], new


def decode_step(rt: Runtime, cfg: ArchConfig, params, batch,
                gen: torch.Generator):
    """batch: {"token": (B,), "pos": int, "cache": the decode state}.
    Returns (next_token (B,), new_cache).  An attention layer's cache is
    the given one, written in place at ``pos``; an SSM layer's state is
    new, re-stacked per period position.  A period stack's attention sees
    every cached position up to ``pos`` (the reference passes no window,
    ``repro/models/model.py:641``)."""
    token, pos, cache = batch["token"], int(batch["pos"]), batch["cache"]
    x = _embed_tokens(rt, cfg, params, token[:, None], gen)[:, 0]
    caches, kinds, _ = _stacks(cfg, cache)
    s_cache = next((c["k"].shape[2] for c in caches if "k" in c), 0)
    windows = layer_windows(cfg, s_cache)
    pos_t = torch.full((), pos, dtype=torch.int32, device=x.device) \
        if s_cache else None
    states = [[] for _ in kinds]
    for i, kind, p in _blocks(cfg, params):
        j = i % len(kinds)
        x, nc = _block_decode(rt, cfg, kind, p, x,
                              _layer(caches[j], i // len(kinds)), pos,
                              pos_t, windows[i])
        states[j].append(nc)
    new = [c if kind.startswith("attn")
           else {k: torch.stack([nc[k] for nc in states[j]]) for k in c}
           for j, (kind, c) in enumerate(zip(kinds, caches))]
    h = rms_norm(x, params["final_norm"])
    return (vocab_parallel_greedy(rt, params["embed"], h),
            new if cfg.period is not None else new[0])
