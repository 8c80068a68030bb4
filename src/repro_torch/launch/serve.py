"""LM serving: batched prefill and greedy decode on the model stack (the
port of ``repro.launch.serve``; the SSM, dense, MoE, hybrid, audio and
VLM families).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_4b \\
        --device cpu                          # reduced config, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3_moe_30b_a3b --device cpu --model-parallel 2
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba_v0_1_52b --device cpu   # the reduced period stack
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper_tiny --device cpu     # the reduced encoder-decoder

The prompt enters through the parties' secure vocabulary embedding and
each token leaves through the party-sharded greedy head, with fresh masks
at every step (one mask generator, seeded from ``seed``, runs on through
the whole call).  A dense prefill's KV cache is put at positions
[0, prompt_len) of a decode cache of ``prompt_len + gen_tokens``
positions (rounded up to a multiple of the party count, so the parties'
cache shards are equal; the positions past the last token are never
attended), and decode step i runs at position ``prompt_len + i``.
An encoder-decoder's prefill also gives the cross attention's K/V of the
encoder output (enc_seq positions), put at the start of the decode
cache's ``xk``/``xv`` (enc_seq rounded up to a multiple of q), which
decoding reads and never writes.  A VLM's ``prompt_len`` counts its
``n_patches`` patch positions, as the reference's does: the prompt is the
patches and ``prompt_len − n_patches`` text tokens.  An
MoE model spreads its experts over the parties (``replicated``
dispatch, ``Runtime``'s default).  As in the reference, the SSM prefill
hands no state to the decode loop, which starts from ``init_cache``'s
zeros (ROADMAP C.R3), and so does a period stack's (jamba) for every
layer: its decode starts from zero SSM states and a zero KV cache, whose
``prompt_len`` zero keys its attention layers still attend over (C.R6).
A period stack's ``n_layers`` must be a whole number of periods.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.configs.inputs import make_batch
from repro_torch.core.secure_agg import mask_generator
from repro_torch.models import model as model_lib
from repro_torch.sharding.api import Runtime


class ServeResult(NamedTuple):
    tokens: np.ndarray          # (batch, gen_tokens) int64
    prefill_seconds: float      # prefill and the decode cache's set-up
    step_seconds: List[float]   # each of the gen_tokens - 1 decode steps
    cache: Any                  # the decode state after the last step
    #                             (a dict, or a period stack's list)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, batch: int = 4, prompt_len: int = 32,
          gen_tokens: int = 16, reduced: bool = True,
          model_parallel: int = 1, seed: int = 0, *, device="cuda",
          secure_mode: str = "two_tree",
          schedule_faithful: bool = False,
          n_layers: Optional[int] = None) -> ServeResult:
    """Prefill a random (batch, prompt_len) prompt and decode
    ``gen_tokens`` greedy tokens (the first from the prefill) with
    random parameters from ``seed``, across ``model_parallel`` parties
    (q, each owning a vocabulary block, and an MoE model's E/q experts).
    ``n_layers``, where given, cuts the stack to its first ``n_layers``
    layers (the widths stay; a period stack's to whole periods, else
    ``ValueError``).  Times end at a device synchronisation."""
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model_lib.layer_kinds(cfg)
    if cfg.arch_type == "vlm" and prompt_len <= cfg.n_patches:
        raise ValueError(f"{cfg.name}'s prompt_len {prompt_len} counts its "
                         f"{cfg.n_patches} patches and must exceed it")
    dev = resolve_device(device)
    rt = Runtime(model_size=model_parallel, secure_mode=secure_mode,
                 schedule_faithful=schedule_faithful,
                 attn_chunk=max(16, prompt_len // 2))
    max_len = -(-(prompt_len + gen_tokens) // model_parallel) \
        * model_parallel
    with torch.no_grad():
        params = model_lib.init_params(cfg, seed, device=dev)
        shape = ShapeConfig("serve", prompt_len, batch, "prefill")
        pre_batch = make_batch(cfg, shape, rt, seed=seed, device=dev)
        gen = mask_generator(seed, device=dev)

        _sync(dev)
        t0 = time.perf_counter()
        tok, kv = model_lib.prefill(rt, cfg, params, pre_batch, gen)
        # the reference re-homes only a uniform stack's attention cache,
        # each entry at the start of its decode entry (repro/launch/
        # serve.py:50-56); SSM and period-stack decoding start from zeros
        # (C.R3, C.R6)
        cache = model_lib.init_cache(rt, cfg, batch, max_len, device=dev)
        if kv is not None:
            for name, val in kv.items():
                cache[name][:, :, :val.shape[2]].copy_(val)
            del kv
        _sync(dev)
        t_pre = time.perf_counter() - t0
        out, steps = [tok], []
        for i in range(gen_tokens - 1):
            t1 = time.perf_counter()
            tok, cache = model_lib.decode_step(
                rt, cfg, params,
                {"token": tok, "pos": prompt_len + i, "cache": cache}, gen)
            _sync(dev)
            steps.append(time.perf_counter() - t1)
            out.append(tok)
        tokens = torch.stack(out, 1).cpu().numpy()
    return ServeResult(tokens, t_pre, steps, cache)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    res = serve(a.arch, a.batch, a.prompt_len, a.gen_tokens,
                reduced=not a.full, model_parallel=a.model_parallel,
                device=a.device)
    steps = res.step_seconds
    print(f"prefill {a.batch}x{a.prompt_len} in {res.prefill_seconds:.2f}s; "
          f"decode {len(steps)} steps in {sum(steps):.2f}s "
          f"({sum(steps) / max(len(steps), 1) * 1e3:.1f} ms/tok)")
    print("generated token ids (first 2 rows):\n", res.tokens[:2])


if __name__ == "__main__":
    main()
