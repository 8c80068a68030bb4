"""The decoder and encoder-decoder models with VFB²'s secure frontends
(the port of ``repro.models.model``: the SSM family, falcon-mamba; the
dense family, gemma3 / stablelm / granite / internlm2; the MoE family,
granite-moe / qwen3-moe; the hybrid period stack, jamba; the audio
encoder-decoder, whisper; and the VLM, pixtral).

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
order within each.  An encoder-decoder's decoder blocks are
``"attn_cross"``: {``norm1``, ``attn``, ``norm_x``, ``xattn``}, cross
attention (``xattn``, its q from the decoder, its k and v from the
encoder's output, no rotary, no mask) after the self attention and no
feed-forward, as the reference builds them (ROADMAP C.R7);
beside the stack it keeps ``enc_proj`` (2·D, D), ``enc_stack`` (enc_layers
``"attn_mlp"`` blocks, their attention non-causal) and ``enc_norm``.  A
VLM keeps ``patch_proj`` (d_patch, D).  The stack runs as a loop over its
layers; an MoE
layer's feed-forward is ``moe.apply_moe_sharded`` over the q parties
under ``Runtime.moe_dispatch``, and its auxiliary terms (load balance,
router z-loss) are summed over the layers into ``train_loss``.  Tokens enter through the paper's secure vocabulary
embedding (``vfl.embed``) and leave through the party-sharded heads
(``vfl.heads``: the loss, the greedy token); the q parties are
``Runtime.model_size``.  Audio frames and image patches enter through
the continuous form, ``vfl.embed.secure_feature_project``: each party
projects its own block of feature columns.  Whisper's frames become the
encoder's input; pixtral's projected patches are a prefix of
``n_patches`` positions before the text tokens, dropped before the loss
head.

Modes: ``train_loss`` (the mean next-token cross-entropy through the
party-sharded ``vocab_parallel_loss``, differentiable on the plain routes),
``prefill`` (the next token after a prompt, and the dense and MoE
families' bf16 KV cache (L, B, S, Hkv, dh); an encoder-decoder's adds the
cross attention's ``xk``/``xv`` (L, B, enc_seq, Hkv, dh)) and
``decode_step`` (one token).  The
dense decode step writes the new K/V in place into the cache at ``pos``
and attends over the cache viewed as q party shards of S/q positions,
whose partial results are merged by log-sum-exp (Algorithm 1's partial
aggregation, unmasked at serving time).  Cross attention in a decode
step reads the ``xk``/``xv`` cache, enc_seq rounded up to a multiple of q
(``enc_pad``), without writing it, its query at the fixed position
enc_seq − 1 (so the padding is never attended) with no rotary.  ``Runtime.attn_impl`` routes the
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

The reference's three ``Runtime`` levers act as there.  ``remat`` (the
default): under autograd, where no cache is filled, each block runs
under ``torch.utils.checkpoint`` and is recomputed in the backward, at
the reference's granularity: a uniform stack's every layer, a period
stack's every whole period, the encoder's every block
(``repro/models/model.py:333-334, 377-378, 438``).  The blocks draw no
random numbers (the masks are drawn in the frontends, outside them), so
the recomputation saves no generator state.  ``unroll_layers=n`` runs
the first min(n, ·) layers of a full-depth tree: a uniform stack's
layers, a period stack's whole periods, the encoder's layers
(``:336-345, 381-390, 439-444``); the aux terms are summed over the
layers that ran, the prefill's cache holds only those, and a decode step
reads the first min(n, ·) layers of the cache it is given and returns a
cache of only those (views of the attention caches written in place, the
SSM states re-stacked).  As in the reference's ``_decode_unrolled``
(``:678-688``), an unrolled period stack's decode runs position-major,
each period position's layers over the periods in turn, where the
prefill and the decode without the lever run period by period (ROADMAP
C.R8).  ``seq_parallel_norms`` is a sharding annotation in the reference
(``:283-289``) and changes nothing on one device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (ACT_DTYPE, apply_mlp, init_mlp,
                                       normal_init, rms_norm)
from repro_torch.sharding.api import Runtime
from repro_torch.vfl.embed import secure_feature_project, secure_vocab_embed
from repro_torch.vfl.heads import vocab_parallel_greedy, vocab_parallel_loss

CACHE_DTYPE = torch.bfloat16
# the MoE terms' weights in train_loss (0 terms for the SSM and dense
# families, which have no router)
AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-3


def layer_kinds(cfg: ArchConfig):
    """Per-layer kind sequence of the decoder stack, as the reference's: a
    period stack's period repeated n_layers / len(period) times.  An
    encoder-decoder's is ``"attn_mlp"``, as in the reference; its blocks
    are ``"attn_cross"`` (``_stacks``)."""
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


def _init_attn(gen: torch.Generator, cfg: ArchConfig, n: int):
    d = cfg.d_model
    hd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv * cfg.head_dim
    return {"wq": normal_init(gen, (n, d, hd)),
            "wk": normal_init(gen, (n, d, kvd)),
            "wv": normal_init(gen, (n, d, kvd)),
            "wo": normal_init(gen, (n, hd, d),
                              scale=0.02 / math.sqrt(2 * cfg.n_layers))}


def _init_block(gen: torch.Generator, cfg: ArchConfig, kind: str, n: int):
    """``n`` stacked blocks of ``kind`` (leading axis n), each tensor
    drawn whole: ``norm1`` and the mixer (``ssm``, or ``attn`` for a kind
    starting "attn"), then, for a kind ending "mlp" or "moe", ``norm2``
    and that feed-forward; ``"attn_cross"`` (an encoder-decoder's decoder
    block) is ``norm1``, ``attn``, ``norm_x`` and the cross attention
    ``xattn``, with no feed-forward, as in the reference (its
    ``_init_block`` gives a feed-forward only to a kind ending "mlp" or
    "moe", ``repro/models/model.py:84-103``; ROADMAP C.R7)."""
    d, dev = cfg.d_model, gen.device
    block = {"norm1": torch.zeros((n, d), device=dev)}
    if kind.startswith("attn"):
        block["attn"] = _init_attn(gen, cfg, n)
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
    if kind == "attn_cross":
        block["norm_x"] = torch.zeros((n, d), device=dev)
        block["xattn"] = _init_attn(gen, cfg, n)
    return block


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device="cuda") -> Dict[str, Any]:
    """Random parameters from a generator on ``device`` seeded with
    ``seed``, each stacked tensor drawn whole (no per-layer copies): the
    uniform ``stack``, or a period stack's ``periods``, one stacked tree
    per period position; an encoder-decoder's encoder (``enc_proj``,
    ``enc_stack``, ``enc_norm``) and a VLM's ``patch_proj`` beside it
    (``repro/models/model.py:113-140``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    d = cfg.d_model
    params = {"embed": normal_init(gen, (cfg.padded_vocab, d)),
              "final_norm": torch.zeros((d,), device=dev)}
    _, kinds, n = _stacks(cfg, None)
    if cfg.period is None:
        params["stack"] = _init_block(gen, cfg, kinds[0], n)
    else:
        params["periods"] = [_init_block(gen, cfg, kind, n)
                             for kind in kinds]
    if cfg.enc_dec:
        params["enc_proj"] = normal_init(gen, (2 * d, d))
        params["enc_stack"] = _init_block(gen, cfg, "attn_mlp",
                                          cfg.enc_layers)
        params["enc_norm"] = torch.zeros((d,), device=dev)
    if cfg.arch_type == "vlm":
        params["patch_proj"] = normal_init(gen, (cfg.d_patch, d))
    return params


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stacks(cfg: ArchConfig, tree):
    """A params or cache tree's stacks, one per period position (the
    uniform stack is a period of one kind; an encoder-decoder's decoder
    blocks are ``"attn_cross"``), with their kinds and the layers each
    holds."""
    if cfg.period is None:
        kinds = ("attn_cross",) if cfg.enc_dec else layer_kinds(cfg)[:1]
        return [tree], kinds, cfg.n_layers
    kinds = layer_kinds(cfg)[:len(cfg.period)]
    return tree, kinds, cfg.n_layers // len(cfg.period)


def _depth(rt: Runtime, n: int) -> int:
    """How many of a stack's ``n`` layers (or periods) run:
    min(``rt.unroll_layers``, n), all of them without the lever."""
    return n if rt.unroll_layers is None else min(rt.unroll_layers, n)


def _periods(cfg: ArchConfig, params, n_run=None) -> Iterator[list]:
    """Each of the stack's first ``n_run`` periods (all where None) as a
    list of (layer, kind, block parameters) in order: a uniform stack's
    period is one layer; layer i·len(period) + pos is
    ``periods[pos][i]``."""
    stacks, kinds, n = _stacks(cfg, params["stack"] if cfg.period is None
                               else params["periods"])
    for i in range(n if n_run is None else n_run):
        yield [(i * len(kinds) + pos, kind, _layer(stacks[pos], i))
               for pos, kind in enumerate(kinds)]


def _blocks(cfg: ArchConfig, params) -> Iterator[Tuple[int, str, Any]]:
    """(layer, kind, block parameters) of every layer in the stack's
    order: period by period, the positions in order within each."""
    for period in _periods(cfg, params):
        yield from period


def _remat(on: bool, fn, *args, **kw):
    """``fn(*args, **kw)``; where ``on`` and autograd records, under
    ``torch.utils.checkpoint``: only the inputs are kept and ``fn`` runs
    again in the backward.  ``fn`` must draw no random numbers and write
    nothing in place."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return fn(*args, **kw)


def _embed_tokens(rt: Runtime, cfg: ArchConfig, params, tokens,
                  gen: torch.Generator):
    if rt.secure_embed:
        return secure_vocab_embed(rt, params["embed"], tokens, gen)
    return params["embed"][tokens].to(ACT_DTYPE)


def _project_features(rt: Runtime, w, feats, gen: torch.Generator):
    """Audio frames or image patches (B, S, d_in) through the parties'
    secure projection, or the plain bf16 product where
    ``rt.secure_embed`` is off."""
    if rt.secure_embed:
        return secure_feature_project(rt, w, feats, gen)
    return feats.to(ACT_DTYPE) @ w.to(ACT_DTYPE)


def _encode_frames(rt: Runtime, cfg: ArchConfig, params, frames,
                   gen: torch.Generator):
    """The encoder over the stub frame embeddings (B, enc_seq, 2·D): the
    secure projection, enc_layers non-causal ``"attn_mlp"`` blocks (their
    rotary at positions 0..enc_seq−1, no window), then ``enc_norm``
    (``repro/models/model.py:414-434``); the first min(unroll_layers,
    enc_layers) blocks, each checkpointed under ``rt.remat``."""
    x = _project_features(rt, params["enc_proj"], frames, gen)
    for i in range(_depth(rt, cfg.enc_layers)):
        x, _ = _remat(rt.remat, _block_fwd, rt, cfg, "attn_mlp",
                      _layer(params["enc_stack"], i), x, None, causal=False)
    return rms_norm(x, params["enc_norm"])


def _prepare_inputs(rt: Runtime, cfg: ArchConfig, params, batch,
                    gen: torch.Generator):
    """Embed the modality inputs and the tokens; returns (x, enc_out,
    n_prefix) as the reference does: an encoder-decoder's encoder output
    (B, enc_seq, D) beside the embedded tokens, or a VLM's projected
    patches put before them as a prefix of n_prefix = n_patches positions
    (``repro/models/model.py:470-488``).  The tokens' masks are drawn
    from ``gen`` first, then the frames' or patches'."""
    x = _embed_tokens(rt, cfg, params, batch["tokens"], gen)
    enc_out, n_prefix = None, 0
    if cfg.enc_dec:
        enc_out = _encode_frames(rt, cfg, params, batch["frames"], gen)
    if cfg.arch_type == "vlm":
        patches = _project_features(rt, params["patch_proj"],
                                    batch["patches"], gen)
        x = torch.cat([patches, x], 1)
        n_prefix = patches.shape[1]
    return x, enc_out, n_prefix


# ---------------------------------------------------------------------------
# forward blocks (prefill)
# ---------------------------------------------------------------------------

def _pick_chunk(s: int, target: int) -> int:
    """The largest query chunk ≤ ``target`` that divides ``s``."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _apply_attention(rt: Runtime, cfg: ArchConfig, p, x, window,
                     *, causal: bool = True, kv_src=None):
    """Attention of x (B, S, D) over itself, or, for cross attention,
    over ``kv_src`` (B, Skv, D) (``repro/models/model.py:230-256``).
    Self attention applies rotary positions 0..S−1 to q and k; cross
    attention none.  ``causal`` and ``window`` (None: no window) mask the
    pairs.  Returns (out (B, S, D), (k, v)), k and v (B, Skv, Hkv, dh) for
    the cache."""
    b, s, _ = x.shape
    dh, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv
    src = x if kv_src is None else kv_src
    q = (x @ p["wq"].to(x.dtype)).view(b, s, h, dh)
    k = (src @ p["wk"].to(x.dtype)).view(b, src.shape[1], hkv, dh)
    v = (src @ p["wv"].to(x.dtype)).view(b, src.shape[1], hkv, dh)
    if kv_src is None:
        positions = torch.arange(s, device=x.device)[None]
        q = attn_lib.apply_rope_positions(q, positions, cfg.rope_theta)
        k = attn_lib.apply_rope_positions(k, positions, cfg.rope_theta)
    if rt.attn_impl == "kernel":
        # (B, S, H, dh) read as (B, H, S, dh) views, written back in place
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window).transpose(1, 2)
    else:
        o = attn_lib.chunked_attention(q, k, v, causal=causal, window=window,
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


def _block_fwd(rt: Runtime, cfg: ArchConfig, kind: str, p, x, window,
               kv_out=None, *, enc_out=None, causal: bool = True):
    """One block over a sequence (prefill): the mixer (attention for a
    kind starting "attn", ``causal`` or not, else the SSM), for
    ``"attn_cross"`` then the cross attention over ``enc_out`` (B,
    enc_seq, D), then the block's feed-forward, if it has one
    (``repro/models/model.py:294-316``).  ``kv_out``: an attention
    layer's {"k", "v"} cache slices (B, S, Hkv, dh) to fill, and for
    ``"attn_cross"`` its {"xk", "xv"} (B, enc_seq, Hkv, dh), or None.
    Returns (x, aux) as ``_apply_ffn``."""
    h = rms_norm(x, p["norm1"])
    if kind.startswith("attn"):
        o, (k, v) = _apply_attention(rt, cfg, p["attn"], h, window,
                                     causal=causal)
        if kv_out is not None:
            kv_out["k"].copy_(k)
            kv_out["v"].copy_(v)
        if "xattn" in p:
            x = x + o
            o, (k, v) = _apply_attention(rt, cfg, p["xattn"],
                                         rms_norm(x, p["norm_x"]), None,
                                         causal=False, kv_src=enc_out)
            if kv_out is not None:
                kv_out["xk"].copy_(k)
                kv_out["xv"].copy_(v)
    else:
        o = ssm_lib.apply_ssm(p["ssm"], h, scan_impl=rt.scan_impl)
    return _apply_ffn(rt, cfg, p, x + o)


def _period_fwd(rt: Runtime, cfg: ArchConfig, blocks, x, windows, kv, aux,
                enc_out):
    """One period's blocks (``_periods``' list) over x; returns (x, aux
    with each block's terms added)."""
    for i, kind, p in blocks:
        x, layer_aux = _block_fwd(rt, cfg, kind, p, x, windows[i],
                                  None if kv is None else _layer(kv, i),
                                  enc_out=enc_out)
        aux = {k: aux[k] + layer_aux[k] for k in aux}
    return x, aux


def _backbone(rt: Runtime, cfg: ArchConfig, params, x, *, kv=None,
              aux=None, enc_out=None):
    """The stack, layer by layer, and the final norm: (B, S, D) → the
    normed hidden states (B, S, D).  Each layer's window is
    ``layer_windows(cfg, S)``'s (every layer of a period stack: S);
    ``kv``, where given, is a uniform stack's {"k", "v"} cache (L, B, S,
    Hkv, dh) the layers fill (an encoder-decoder's also {"xk", "xv"}),
    L the layers that run; ``aux``, where given, is a {"lb_loss",
    "z_loss"} dict each layer's terms are added to; ``enc_out`` is an
    encoder-decoder's encoder output.  The first
    ``_depth(rt, ·)`` periods run (a uniform stack's period is a layer),
    each checkpointed under ``rt.remat`` where no cache is filled."""
    windows = layer_windows(cfg, x.shape[1])
    run = {} if aux is None else dict(aux)
    for blocks in _periods(cfg, params,
                           _depth(rt, _stacks(cfg, None)[2])):
        x, run = _remat(rt.remat and kv is None, _period_fwd, rt, cfg,
                        blocks, x, windows, kv, run, enc_out)
    if aux is not None:
        aux.update(run)
    return rms_norm(x, params["final_norm"])


def train_loss(rt: Runtime, cfg: ArchConfig, params, batch,
               gen: torch.Generator) -> torch.Tensor:
    """Mean next-token cross-entropy (0-d f32) of ``batch`` = {"tokens",
    "labels"}, each (B, S_text), with an encoder-decoder's "frames" or a
    VLM's "patches" (``repro/models/model.py:491-501``): the secure
    frontends (masks from ``gen``), the stack without a KV cache, the
    final norm, the VLM's patch prefix dropped, and
    ``vocab_parallel_loss`` on the tied table, plus the MoE auxiliary
    terms summed over the layers (0 for the families without a router)."""
    x, enc_out, n_prefix = _prepare_inputs(rt, cfg, params, batch, gen)
    aux = _no_aux()
    h = _backbone(rt, cfg, params, x, aux=aux, enc_out=enc_out)
    if n_prefix:
        h = h[:, n_prefix:]
    loss = vocab_parallel_loss(rt, params["embed"], h, batch["labels"],
                               cfg.padded_vocab)
    return loss + AUX_LOSS_WEIGHT * aux["lb_loss"] \
        + Z_LOSS_WEIGHT * aux["z_loss"]


def prefill(rt: Runtime, cfg: ArchConfig, params, batch,
            gen: torch.Generator):
    """Forward over the prompt (``batch`` as ``train_loss``'s, without
    labels); returns (next_token (B,), cache).  The attention families'
    cache is {"k", "v"}, each (L, B, S, Hkv, dh) bf16 with rotary
    positions applied to k, S counting a VLM's patch prefix; an
    encoder-decoder's adds {"xk", "xv"} (L, B, enc_seq, Hkv, dh), the
    cross attention's K/V of the encoder output
    (``repro/models/model.py:504-522``).  The SSM family's and a period
    stack's is ``None``, as in the reference (C.R3, C.R6).  Under
    ``rt.unroll_layers`` the cache's L is the layers that ran."""
    x, enc_out, _ = _prepare_inputs(rt, cfg, params, batch, gen)
    kv = None
    if cfg.period is None and layer_kinds(cfg)[0] != "ssm":
        lead = (_depth(rt, cfg.n_layers), x.shape[0])
        tail = (cfg.n_kv, cfg.head_dim)
        kv = {n: torch.empty(lead + (x.shape[1],) + tail,
                             dtype=CACHE_DTYPE, device=x.device)
              for n in ("k", "v")}
        if enc_out is not None:
            kv.update({n: torch.empty(lead + (enc_out.shape[1],) + tail,
                                      dtype=CACHE_DTYPE, device=x.device)
                       for n in ("xk", "xv")})
    h = _backbone(rt, cfg, params, x, kv=kv, enc_out=enc_out)
    return vocab_parallel_greedy(rt, params["embed"], h[:, -1]), kv


# ---------------------------------------------------------------------------
# decode (one token against the party-sharded cache)
# ---------------------------------------------------------------------------

def init_cache(rt: Runtime, cfg: ArchConfig, batch: int, seq_len: int, *,
               device="cuda"):
    """The zero decode state.  Dense: the KV cache {"k", "v"}, each
    (L, B, seq_len, Hkv, dh) bf16, its sequence axis split over the q
    parties (so q must divide seq_len to decode); an encoder-decoder's
    adds the cross cache {"xk", "xv"}, each (L, B, enc_pad, Hkv, dh),
    enc_pad = enc_seq rounded up to a multiple of q
    (``repro/models/model.py:535-545``).  SSM: conv (L, B, K−1, Ci) bf16
    and h (L, B, Ci, N) f32 (``seq_len`` does not size an SSM state).  A
    period stack: the list of one such entry per period position, each
    with leading axis n_per in place of L."""
    _, kinds, n = _stacks(cfg, None)
    dev = resolve_device(device)
    q = rt.model_size

    def entry(kind):
        if kind.startswith("attn"):
            lead, tail = (n, batch), (cfg.n_kv, cfg.head_dim)
            out = {name: torch.zeros(lead + (seq_len,) + tail,
                                     dtype=CACHE_DTYPE, device=dev)
                   for name in ("k", "v")}
            if kind == "attn_cross":
                enc_pad = -(-cfg.enc_seq // q) * q
                out.update({name: torch.zeros(
                    lead + (enc_pad,) + tail, dtype=CACHE_DTYPE, device=dev)
                    for name in ("xk", "xv")})
            return out
        s = cfg.ssm
        return ssm_lib.init_ssm_cache(batch, cfg.d_model, s.d_state,
                                      s.d_conv, s.expand, lead=(n,),
                                      device=dev)

    cache = [entry(kind) for kind in kinds]
    return cache if cfg.period is not None else cache[0]


def _decode_attention(rt: Runtime, cfg: ArchConfig, p, x, kc, vc, pos: int,
                      pos_t: torch.Tensor, window, *, cross: bool = False):
    """One token's attention against the layer's cache (B, S, Hkv, dh),
    seen as q party shards of S/q positions.  x: (B, D); ``pos_t`` is
    ``pos`` as a 0-d int32 tensor on x's device.  Self attention: the new
    K/V are written into the cache at ``pos`` in place (on one device
    every party's write lands in the one shard that owns ``pos``), with
    rotary at ``pos`` on q and k.  ``cross``: the reference's
    ``update=False, causal=False`` branch (``repro/models/model.py:
    593-645``): the cache holds the encoder's projected K/V and is read
    only, q gets no rotary, and ``pos``/``pos_t`` must be enc_seq − 1, so
    the padding past the encoder's length is never attended.  The shards'
    partials are merged by log-sum-exp.  Returns the attention output
    (B, D)."""
    b = x.shape[0]
    dh, h, hkv, q_par = cfg.head_dim, cfg.n_heads, cfg.n_kv, rt.model_size
    s = kc.shape[1]
    if s % q_par:
        raise ValueError(f"the cache's {s} positions do not split into "
                         f"{q_par} party shards")
    q = (x @ p["wq"].to(x.dtype)).view(b, 1, h, dh)
    if not cross:
        at = pos_t.view(1, 1)
        q = attn_lib.apply_rope_positions(q, at, cfg.rope_theta)
        k_new = attn_lib.apply_rope_positions(
            (x @ p["wk"].to(x.dtype)).view(b, 1, hkv, dh), at,
            cfg.rope_theta)[:, 0]
        kc[:, pos] = k_new
        vc[:, pos] = (x @ p["wv"].to(x.dtype)).view(b, hkv, dh)
    q = q[:, 0]
    if rt.attn_impl == "kernel":
        o, m, l = ops.decode_attention(q, kc, vc, pos_t, 0, window,
                                       shards=q_par, pos_value=pos)
    else:
        o, m, l = attn_lib.shard_partials(q, kc, vc, pos, q_par,
                                          window=window)
    o = attn_lib.merge_partial_attention(o, m, l).to(x.dtype)
    return o.reshape(b, h * dh) @ p["wo"].to(x.dtype)


def _block_decode(rt: Runtime, cfg: ArchConfig, kind: str, p, x, cache,
                  pos: int, pos_t, window, xpos_t=None):
    """One block, one token: the mixer, for ``"attn_cross"`` then the
    cross attention over the layer's {"xk", "xv"} at enc_seq − 1
    (``xpos_t``, a 0-d int32 tensor on x's device), then the block's
    feed-forward, if it has one (``repro/models/model.py:648-669``).
    x: (B, D).  Returns (x, new_cache): a new SSM state, or the layer's
    KV cache itself, written in place."""
    h = rms_norm(x, p["norm1"])
    if kind.startswith("attn"):
        o = _decode_attention(rt, cfg, p["attn"], h, cache["k"], cache["v"],
                              pos, pos_t, window)
        if "xattn" in p:
            x = x + o
            o = _decode_attention(rt, cfg, p["xattn"],
                                  rms_norm(x, p["norm_x"]), cache["xk"],
                                  cache["xv"], cfg.enc_seq - 1, xpos_t,
                                  None, cross=True)
        new = cache
    else:
        o, new = ssm_lib.apply_ssm_decode(p["ssm"], h, cache)
    x, _ = _apply_ffn(rt, cfg, p, (x + o)[:, None])   # decode drops the aux
    return x[:, 0], new


def decode_step(rt: Runtime, cfg: ArchConfig, params, batch,
                gen: torch.Generator):
    """batch: {"token": (B,), "pos": int, "cache": the decode state}.
    Returns (next_token (B,), new_cache).  An attention layer's cache is
    the given one, written in place at ``pos`` (an encoder-decoder's
    cross cache is only read); an SSM layer's state is new, re-stacked
    per period position.  A period stack's attention sees every cached
    position up to ``pos`` (the reference passes no window,
    ``repro/models/model.py:641``).

    Under ``rt.unroll_layers`` the first min(n, ·) layers (a period
    stack's periods) of the given cache are read and the returned cache
    holds only those: an attention cache's first layers as views of the
    given one.  An unrolled period stack runs position-major, as the
    reference's ``_decode_unrolled`` (``:678-688``) does: each period
    position over the periods that run, then the next position (ROADMAP
    C.R8)."""
    token, pos, cache = batch["token"], int(batch["pos"]), batch["cache"]
    x = _embed_tokens(rt, cfg, params, token[:, None], gen)[:, 0]
    caches, kinds, n = _stacks(cfg, cache)
    s_cache = next((c["k"].shape[2] for c in caches if "k" in c), 0)
    windows = layer_windows(cfg, s_cache)
    pos_t = torch.full((), pos, dtype=torch.int32, device=x.device) \
        if s_cache else None
    xpos_t = torch.full((), cfg.enc_seq - 1, dtype=torch.int32,
                        device=x.device) if cfg.enc_dec else None
    n_run = _depth(rt, n)
    blocks = [b for period in _periods(cfg, params, n_run) for b in period]
    if rt.unroll_layers is not None:
        # position-major (C.R8); a uniform stack's order is the same
        blocks.sort(key=lambda b: b[0] % len(kinds))
    states = [[] for _ in kinds]
    for i, kind, p in blocks:
        j = i % len(kinds)
        x, nc = _block_decode(rt, cfg, kind, p, x,
                              _layer(caches[j], i // len(kinds)), pos,
                              pos_t, windows[i], xpos_t)
        states[j].append(nc)
    new = [({k: v[:n_run] for k, v in c.items()}
            if rt.unroll_layers is not None else c)
           if kind.startswith("attn")
           else {k: torch.stack([nc[k] for nc in states[j]]) for k in c}
           for j, (kind, c) in enumerate(zip(kinds, caches))]
    h = rms_norm(x, params["final_norm"])
    return (vocab_parallel_greedy(rt, params["embed"], h),
            new if cfg.period is not None else new[0])
