"""The decoder model with VFB²'s secure frontends (the port of
``repro.models.model``, the SSM family: falcon-mamba).

Parameters are the reference's stacked-layer dict: ``embed`` (V_pad, D),
``final_norm`` (D,) and ``stack`` = {``norm1`` (L, D), ``ssm``: each
block parameter with a leading layer axis}.  The stack runs as a loop over
its layers.  Tokens enter through the paper's secure vocabulary embedding
(``vfl.embed``) and leave through the party-sharded greedy head
(``vfl.heads``); the q parties are ``Runtime.model_size``.

Modes: ``prefill`` (the next token after a prompt) and ``decode_step``
(one token against the SSM state).  As in the reference, ``prefill``
collects no state for the SSM family and returns ``None`` as its cache
(``repro/models/model.py:508``): decoding starts from ``init_cache``'s
zero state, so the tokens after the first do not see the prompt (ROADMAP
C.R3, mirrored so the port can be held against the reference).

Other families raise ``NotImplementedError`` naming ROADMAP A15;
``train_loss`` comes with LM training.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import ACT_DTYPE, normal_init, rms_norm
from repro_torch.sharding.api import Runtime
from repro_torch.vfl.embed import secure_vocab_embed
from repro_torch.vfl.heads import vocab_parallel_greedy


def _unported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet: the port's LM stack has the SSM family "
        "(prefill and greedy decode) only; the rest is ROADMAP A15")


def layer_kinds(cfg: ArchConfig):
    """Per-layer kind sequence of the decoder stack."""
    if cfg.arch_type != "ssm" or cfg.period is not None or cfg.enc_dec:
        _unported(f"{cfg.name} ({cfg.arch_type} layers)")
    return ("ssm",) * cfg.n_layers


def init_params(cfg: ArchConfig, seed: int = 0, *,
                device="cuda") -> Dict[str, Any]:
    """Random parameters from a generator on ``device`` seeded with
    ``seed``, each stacked tensor drawn whole (no per-layer copies)."""
    layer_kinds(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    s, n, d = cfg.ssm, cfg.n_layers, cfg.d_model
    return {
        "embed": normal_init(gen, (cfg.padded_vocab, d)),
        "final_norm": torch.zeros((d,), device=dev),
        "stack": {
            "norm1": torch.zeros((n, d), device=dev),
            "ssm": ssm_lib.init_ssm(gen, d, s.d_state, s.d_conv, s.expand,
                                    lead=(n,)),
        },
    }


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
    does (no encoder and no prefix in the SSM family)."""
    if cfg.enc_dec or cfg.arch_type == "vlm":
        _unported(f"{cfg.name}'s {cfg.arch_type} frontend")
    return _embed_tokens(rt, cfg, params, batch["tokens"], gen), None, 0


def _block_fwd(rt: Runtime, cfg: ArchConfig, kind: str, p, x):
    """One decoder block over a sequence (prefill)."""
    if kind != "ssm":
        _unported(f"the {kind!r} block")
    h = rms_norm(x, p["norm1"])
    return x + ssm_lib.apply_ssm(p["ssm"], h, scan_impl=rt.scan_impl)


def _backbone(rt: Runtime, cfg: ArchConfig, params, x):
    """The stack, layer by layer, and the final norm: (B, S, D) → the
    normed hidden states (B, S, D)."""
    for i, kind in enumerate(layer_kinds(cfg)):
        x = _block_fwd(rt, cfg, kind, _layer(params["stack"], i), x)
    return rms_norm(x, params["final_norm"])


def prefill(rt: Runtime, cfg: ArchConfig, params, batch,
            gen: torch.Generator):
    """Forward over the prompt ``batch["tokens"]`` (B, S); returns
    (next_token (B,), cache).  The cache is ``None`` for the SSM family,
    as in the reference (C.R3)."""
    x, _, _ = _prepare_inputs(rt, cfg, params, batch, gen)
    h = _backbone(rt, cfg, params, x)
    return vocab_parallel_greedy(rt, params["embed"], h[:, -1]), None


def init_cache(rt: Runtime, cfg: ArchConfig, batch: int, seq_len: int, *,
               device="cuda"):
    """The zero SSM state for ``decode_step``: conv (L, B, K−1, Ci) bf16
    and h (L, B, Ci, N) f32 (``seq_len`` does not size an SSM state)."""
    layer_kinds(cfg)
    s = cfg.ssm
    return ssm_lib.init_ssm_cache(batch, cfg.d_model, s.d_state, s.d_conv,
                                  s.expand, lead=(cfg.n_layers,),
                                  device=device)


def _block_decode(rt: Runtime, cfg: ArchConfig, kind: str, p, x, cache):
    """One block, one token.  x: (B, D).  Returns (x, new_cache)."""
    if kind != "ssm":
        _unported(f"the {kind!r} decode block")
    h = rms_norm(x, p["norm1"])
    o, new = ssm_lib.apply_ssm_decode(p["ssm"], h, cache)
    return x + o, new


def decode_step(rt: Runtime, cfg: ArchConfig, params, batch,
                gen: torch.Generator):
    """batch: {"token": (B,), "pos": int, "cache": the SSM state}.
    Returns (next_token (B,), new_cache)."""
    token, cache = batch["token"], batch["cache"]
    x = _embed_tokens(rt, cfg, params, token[:, None], gen)[:, 0]
    new = []
    for i, kind in enumerate(layer_kinds(cfg)):
        x, nc = _block_decode(rt, cfg, kind, _layer(params["stack"], i), x,
                              _layer(cache, i))
        new.append(nc)
    new_cache = {k: torch.stack([nc[k] for nc in new]) for k in cache}
    h = rms_norm(x, params["final_norm"])
    return vocab_parallel_greedy(rt, params["embed"], h), new_cache
