"""Carry parameters across from the JAX package to the port.

The JAX package's parameters arrive as numpy arrays (``np.asarray`` of its
arrays, done by the caller, so this module never imports JAX):

* a linear iterate, ``(d,)`` or party-stacked ``(q, dp)``;
* SVRG's state beside the iterate: the snapshot and its full gradient;
* SAGA's state beside the iterate: the ϑ̃ table, ``(n,)`` or every
  party's copy ``(q, n)``, and its running average ``(d,)`` or
  ``(q, dp)``;
* deep parameters, as an object with the ``DeepVFLParams`` fields
  (``enc_w1``, ``enc_b1``, ``enc_w2``, ``head``) holding arrays, or the
  packed 4-tuple ``(w1q, b1q, w2q, headq)``;
* the LM stack's parameter tree of the SSM family (``embed``,
  ``final_norm`` and ``stack`` = {``norm1``, ``ssm``: {...}}) or of the
  dense family (``stack`` = {``norm1``, ``attn``: {``wq``, ``wk``,
  ``wv``, ``wo``}, ``norm2``, ``mlp``: {``w_gate``, ``w_up``,
  ``w_down``}}) or of the MoE family (the dense family's with ``moe``:
  {``router``, ``w_gate``, ``w_up``, ``w_down``} in place of ``mlp``),
  every stack leaf with its leading layer axis; or a period stack's
  (jamba: ``periods``, a list with one stacked tree per period position,
  each a mixer, {``norm1``, ``ssm``} or {``norm1``, ``attn``}, with a
  feed-forward, {``norm2``, ``mlp``} or {``norm2``, ``moe``}); or an
  encoder-decoder's (whisper: ``stack`` = {``norm1``, ``attn``,
  ``norm_x``, ``xattn``}, ``xattn`` as ``attn``, beside ``enc_proj``,
  ``enc_stack``, a dense stack, and ``enc_norm``); or a VLM's (pixtral:
  the dense family's with ``patch_proj``).

Both keep their layout: the port packs and stacks exactly as the
reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.deep_vfl import DeepVFLParams


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def linear_iterate(w, *, device="cuda") -> torch.Tensor:
    """A ``(d,)`` or ``(q, dp)`` iterate as an f32 tensor on ``device``."""
    w = np.asarray(w, np.float32)
    if w.ndim not in (1, 2):
        raise ValueError(f"linear iterate must be (d,) or (q, dp), got "
                         f"{w.shape}")
    return _tensor(w, resolve_device(device))


def svrg_state(w_snap, mu, *, device="cuda"):
    """SVRG's snapshot and its full gradient, each ``(d,)`` or
    ``(q, dp)``, as f32 tensors on ``device``."""
    return (linear_iterate(w_snap, device=device),
            linear_iterate(mu, device=device))


def saga_state(tab, avg, *, device="cuda"):
    """SAGA's ϑ̃ table, ``(n,)`` or ``(q, n)``, and its running average,
    ``(d,)`` or ``(q, dp)``, as f32 tensors on ``device``."""
    tab = np.asarray(tab, np.float32)
    if tab.ndim not in (1, 2):
        raise ValueError(f"SAGA table must be (n,) or (q, n), got "
                         f"{tab.shape}")
    dev = resolve_device(device)
    return _tensor(tab, dev), linear_iterate(avg, device=dev)


def deep_params(params, *, device="cuda"):
    """Deep parameters on ``device``: a ``DeepVFLParams``-shaped object
    becomes the port's ``DeepVFLParams``; a packed 4-tuple stays a
    4-tuple of tensors."""
    dev = resolve_device(device)
    if isinstance(params, (tuple, list)):
        if len(params) != 4:
            raise ValueError("packed deep params are the 4-tuple "
                             "(w1q, b1q, w2q, headq)")
        return tuple(_tensor(a, dev) for a in params)
    return DeepVFLParams([_tensor(a, dev) for a in params.enc_w1],
                         [_tensor(a, dev) for a in params.enc_b1],
                         [_tensor(a, dev) for a in params.enc_w2],
                         _tensor(params.head, dev))


# the ported blocks' trees: each subtree's leaf names
_SSM = ("w_in", "conv_w", "conv_b", "w_x_dbc", "w_dt", "dt_bias", "a_log",
        "d_skip", "w_out")
_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("w_gate", "w_up", "w_down")
_MOE = ("router", "w_gate", "w_up", "w_down")
_DENSE = {"norm1": None, "attn": _ATTN, "norm2": None, "mlp": _MLP}
# the reference's decoder block of an encoder-decoder has no feed-forward
_CROSS = {"norm1": None, "attn": _ATTN, "norm_x": None, "xattn": _ATTN}
_LM_STACKS = (
    {"norm1": None, "ssm": _SSM},
    _DENSE,
    {"norm1": None, "attn": _ATTN, "norm2": None, "moe": _MOE},
    {"norm1": None, "ssm": _SSM, "norm2": None, "mlp": _MLP},
    {"norm1": None, "ssm": _SSM, "norm2": None, "moe": _MOE},
)
# the trees' top-level keys: a decoder (uniform or period stack), an
# encoder-decoder's (its decoder stack of _CROSS blocks) or a VLM's
_TOPS = ({"embed", "final_norm", "stack"}, {"embed", "final_norm", "periods"},
         {"embed", "final_norm", "stack", "enc_proj", "enc_stack",
          "enc_norm"},
         {"embed", "final_norm", "stack", "patch_proj"})


def _matches(stack, layout) -> bool:
    return (isinstance(stack, dict) and set(stack) == set(layout)
            and all(leaves is None or (isinstance(stack[k], dict)
                                       and set(stack[k]) == set(leaves))
                    for k, leaves in layout.items()))


def _lm_tree_ok(params) -> bool:
    top = set(params)
    if top not in _TOPS:
        return False
    if "enc_stack" in top:
        return _matches(params["stack"], _CROSS) \
            and _matches(params["enc_stack"], _DENSE)
    if "patch_proj" in top:
        return _matches(params["stack"], _DENSE)
    stacks = params.get("periods", params.get("stack"))
    if not isinstance(stacks, list):
        stacks = [stacks]
    return bool(stacks) and all(any(_matches(s, layout)
                                    for layout in _LM_STACKS)
                                for s in stacks)


def lm_params(params, *, q: int, device="cuda"):
    """The reference's LM parameter tree (SSM, dense, MoE, period stack,
    encoder-decoder or VLM; numpy leaves) as the port's: the same tree of
    f32 tensors on ``device``.  The embedding table must split into ``q``
    party vocabulary blocks."""
    dev = resolve_device(device)
    if not _lm_tree_ok(params):
        raise ValueError(
            "not an LM parameter tree of the reference: want embed, "
            "final_norm and a stack of {norm1, ssm}, {norm1, attn, norm2, "
            "mlp} or {norm1, attn, norm2, moe} blocks; or periods, a list "
            "of such blocks (an SSM mixer with norm2 and mlp or moe "
            "included); or an encoder-decoder's stack of {norm1, attn, "
            "norm_x, xattn} blocks with enc_proj, a dense "
            "enc_stack and enc_norm; or a dense stack with patch_proj; got "
            f"{sorted(params)}")
    if np.shape(params["embed"])[0] % q:
        raise ValueError(f"vocabulary {np.shape(params['embed'])[0]} does "
                         f"not split into {q} party blocks")

    def convert(tree):
        if isinstance(tree, dict):
            return {k: convert(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [convert(v) for v in tree]
        return _tensor(tree, dev)

    return convert(params)
