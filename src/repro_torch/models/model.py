"""The decoder model with VFB²'s secure frontends (the port of
``repro.models.model``: the SSM family, falcon-mamba; the dense family,
gemma3 / stablelm / granite / internlm2; and the MoE family,
granite-moe / qwen3-moe).

Parameters are the reference's stacked-layer dict: ``embed`` (V_pad, D),
``final_norm`` (D,) and ``stack``, each block parameter with a leading
layer axis: {``norm1``, ``ssm``} for the SSM family, {``norm1``, ``attn``
{``wq``, ``wk``, ``wv``, ``wo``}, ``norm2``, ``mlp`` {``w_gate``,
``w_up``, ``w_down``}} for the dense family, the same with ``moe``
{``router``, ``w_gate``, ``w_up``, ``w_down``} (``models.moe``) in place
of ``mlp`` for the MoE family.  The stack runs as a loop over its
layers; an MoE layer's feed-forward is ``moe.apply_moe_sharded`` over the
q parties under ``Runtime.moe_dispatch``, and its auxiliary terms
(load balance, router z-loss) are summed over the layers into
``train_loss``.  Tokens enter through the paper's secure vocabulary
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
held against the reference).

Hybrid (period) stacks (ROADMAP A15c), encoder-decoder (cross
attention) and the VLM frontend (A15d) raise ``NotImplementedError``
naming ROADMAP A15, as does a ``Runtime`` that sets the reference's
``remat``, ``unroll_layers`` or ``seq_parallel_norms`` (A15e).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

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
        "dense and MoE families (training, prefill and greedy decode) "
        "only; the rest is ROADMAP A15 (period stacks A15c, cross "
        "attention and the VLM frontend A15d)")


def layer_kinds(cfg: ArchConfig):
    """Per-layer kind sequence of the decoder stack."""
    if (cfg.arch_type not in ("ssm", "dense", "moe")
            or cfg.period is not None or cfg.enc_dec):
        _unported(f"{cfg.name} ({cfg.arch_type} layers)")
    if cfg.arch_type == "ssm":
        return ("ssm",) * cfg.n_layers
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


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device="cuda") -> Dict[str, Any]:
    """Random parameters from a generator on ``device`` seeded with
    ``seed``, each stacked tensor drawn whole (no per-layer copies)."""
    kinds = layer_kinds(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    n, d = cfg.n_layers, cfg.d_model
    params = {"embed": normal_init(gen, (cfg.padded_vocab, d)),
              "final_norm": torch.zeros((d,), device=dev)}
    if kinds[0] == "ssm":
        s = cfg.ssm
        params["stack"] = {
            "norm1": torch.zeros((n, d), device=dev),
            "ssm": ssm_lib.init_ssm(gen, d, s.d_state, s.d_conv, s.expand,
                                    lead=(n,))}
        return params
    hd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv * cfg.head_dim
    params["stack"] = {
        "norm1": torch.zeros((n, d), device=dev),
        "attn": {"wq": normal_init(gen, (n, d, hd)),
                 "wk": normal_init(gen, (n, d, kvd)),
                 "wv": normal_init(gen, (n, d, kvd)),
                 "wo": normal_init(gen, (n, hd, d),
                                   scale=0.02 / math.sqrt(2 * n))},
        "norm2": torch.zeros((n, d), device=dev),
    }
    if kinds[0] == "attn_moe":
        m = cfg.moe
        params["stack"]["moe"] = moe_lib.init_moe(
            gen, d, m.d_expert, m.n_experts, lead=(n,))
    else:
        params["stack"]["mlp"] = init_mlp(gen, d, cfg.d_ff, lead=(n,))
    return params


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


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
    """One decoder block over a sequence (prefill).  ``kv_out``: the
    layer's {"k", "v"} cache slices (B, S, Hkv, dh) to fill, or None.
    Returns (x, aux) as ``_apply_ffn``."""
    h = rms_norm(x, p["norm1"])
    if kind == "ssm":
        return (x + ssm_lib.apply_ssm(p["ssm"], h, scan_impl=rt.scan_impl),
                _no_aux())
    o, (k, v) = _apply_attention(rt, cfg, p["attn"], h, window)
    if kv_out is not None:
        kv_out["k"].copy_(k)
        kv_out["v"].copy_(v)
    return _apply_ffn(rt, cfg, p, x + o)


def _backbone(rt: Runtime, cfg: ArchConfig, params, x, *, kv=None,
              aux=None):
    """The stack, layer by layer, and the final norm: (B, S, D) → the
    normed hidden states (B, S, D).  Each layer's window is
    ``layer_windows(cfg, S)``'s; ``kv``, where given, is the stacked
    {"k", "v"} cache (L, B, S, Hkv, dh) the layers fill; ``aux``, where
    given, is a {"lb_loss", "z_loss"} dict each layer's terms are added
    to."""
    windows = layer_windows(cfg, x.shape[1])
    for i, kind in enumerate(layer_kinds(cfg)):
        x, layer_aux = _block_fwd(rt, cfg, kind, _layer(params["stack"], i),
                                  x, windows[i],
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
    SSM family's is ``None``, as in the reference (C.R3)."""
    x, _, _ = _prepare_inputs(rt, cfg, params, batch, gen)
    kv = None
    if layer_kinds(cfg)[0] != "ssm":
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
    state)."""
    if layer_kinds(cfg)[0] != "ssm":
        dev = resolve_device(device)
        shape = (cfg.n_layers, batch, seq_len, cfg.n_kv, cfg.head_dim)
        return {n: torch.zeros(shape, dtype=CACHE_DTYPE, device=dev)
                for n in ("k", "v")}
    s = cfg.ssm
    return ssm_lib.init_ssm_cache(batch, cfg.d_model, s.d_state, s.d_conv,
                                  s.expand, lead=(cfg.n_layers,),
                                  device=device)


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
    """One block, one token.  x: (B, D).  Returns (x, new_cache): a new
    SSM state, or the layer's KV cache itself, written in place."""
    h = rms_norm(x, p["norm1"])
    if kind == "ssm":
        o, new = ssm_lib.apply_ssm_decode(p["ssm"], h, cache)
        return x + o, new
    x = x + _decode_attention(rt, cfg, p["attn"], h, cache["k"], cache["v"],
                              pos, pos_t, window)
    x, _ = _apply_ffn(rt, cfg, p, x[:, None])     # decode drops the aux
    return x[:, 0], cache


def decode_step(rt: Runtime, cfg: ArchConfig, params, batch,
                gen: torch.Generator):
    """batch: {"token": (B,), "pos": int, "cache": the decode state}.
    Returns (next_token (B,), new_cache).  The dense family's new cache is
    the given one, written in place at ``pos``; the SSM family's is a new
    state."""
    token, pos, cache = batch["token"], int(batch["pos"]), batch["cache"]
    x = _embed_tokens(rt, cfg, params, token[:, None], gen)[:, 0]
    kinds = layer_kinds(cfg)
    if kinds[0] == "ssm":
        new = []
        for i, kind in enumerate(kinds):
            x, nc = _block_decode(rt, cfg, kind, _layer(params["stack"], i),
                                  x, _layer(cache, i), pos, None, 0)
            new.append(nc)
        cache = {k: torch.stack([nc[k] for nc in new]) for k in cache}
    else:
        windows = layer_windows(cfg, cache["k"].shape[2])
        pos_t = torch.full((), pos, dtype=torch.int32, device=x.device)
        for i, kind in enumerate(kinds):
            x, _ = _block_decode(rt, cfg, kind, _layer(params["stack"], i),
                                 x, _layer(cache, i), pos, pos_t, windows[i])
    h = rms_norm(x, params["final_norm"])
    return vocab_parallel_greedy(rt, params["embed"], h), cache
