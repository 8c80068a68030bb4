"""The port's dense LM serving path against the JAX package, at the
reduced configurations: gemma3-4b (2 layers, d_model 128, 4/2 heads,
d_head 32, window 16, both layers local), the same with
``global_every=2`` (layer 1 global), stablelm-1.6b, granite-8b and
internlm2-20b (2 layers, d_model 128, 4/2 heads, d_head 32, no window).

Parameters come from the reference's ``init_params`` and cross with
``convert.lm_params``; tokens come from both packages' ``make_batch`` or
from one numpy generator.  The masks of the secure embedding cannot be
the reference's bits (torch generators), so the two packages agree to the
mask residue.  Tolerances are ``tests/test_torch_lm.py``'s, with their
reasons there: hidden states and caches within ``HIDDEN_REL`` = 2e-2 of
the largest reference value, tokens equal wherever the reference's
top-two logit margin exceeds ``MARGIN`` = 2⁻⁵ of its largest logit.

The reference runs on one device (its party count 1) and, for the q = 4
cross-check, in a subprocess with 4 forced host devices, where its
decode attention is a shard_map over 4 cache shards.  The port runs at
q = 1 and q = 4 against it.  Tests marked ``cuda`` need the card and
skip here.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from test_torch_lm import (HIDDEN_REL, QS, _assert_rel, _assert_tokens,
                           _jax_logits)

from repro_torch import convert
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.configs.inputs import make_batch
from repro_torch.core.secure_agg import mask_generator
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels import vfl_grad as vg
from repro_torch.launch.serve import serve
from repro_torch.models import model as tm
from repro_torch.sharding.api import Runtime
from repro_torch.vfl.heads import vocab_parallel_greedy

REPO = pathlib.Path(__file__).resolve().parents[1]
# name: (architecture, fields replaced in its reduced config)
ARCHS = {"gemma3": ("gemma3_4b", {}),
         "gemma3_global2": ("gemma3_4b", {"global_every": 2}),
         "stablelm": ("stablelm_1_6b", {}),
         "granite": ("granite_8b", {}),
         "internlm2": ("internlm2_20b", {})}
GEMMAS = ["gemma3", "gemma3_global2"]
PROMPT, STEPS = 4, 4                   # decode cross-check: 4 + 4 positions


def _rt(q, **kw):
    return Runtime(model_size=q, **kw)


def _gen(seed=0):
    return mask_generator(seed, device="cpu")


def _cache_t(jcache, jnp):
    """A reference KV cache as the port's bf16 tensors."""
    return {k: torch.from_numpy(np.array(v.astype(jnp.float32)))
            .to(torch.bfloat16) for k, v in jcache.items()}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its ops are small, and
    the suite runs several test processes on one machine's cores, where
    more threads a process only contend.  The count is put back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import inputs as jinputs
    from repro.configs.base import get_arch as jget_arch
    from repro.models import model as jm
    from repro.sharding.api import single_device_runtime
    return dict(jax=jax, jnp=jnp, jm=jm, inputs=jinputs, get_arch=jget_arch,
                rt=single_device_runtime(attn_chunk=32, loss_chunk=16))


def _jfns(jx, cfg):
    """The reference's model functions for ``cfg``, jitted: ``prefill``,
    ``decode_step``, the prefill's last normed hidden state and a decode
    step's normed hidden state (``decode_step`` returns the token
    only)."""
    jax, jm, rt = jx["jax"], jx["jm"], jx["rt"]

    def layer(tree, i):
        return jax.tree.map(lambda a: a[i], tree)

    def decode_hidden(p, token, cache, pos, key):
        x = jm._embed_tokens(rt, cfg, p, token[:, None], key)[:, 0]
        wins = jm.layer_windows(cfg, cache["k"].shape[2])
        for i in range(cfg.n_layers):
            x, _, _ = jm._block_decode(rt, cfg, "attn_mlp",
                                       layer(p["stack"], i), x,
                                       layer(cache, i), pos, wins[i])
        return jm.rms_norm(x, p["final_norm"])

    def last_hidden(p, tokens, key):
        x = jm._embed_tokens(rt, cfg, p, tokens, key)
        return jm._backbone(rt, cfg, p, x, x.shape[1])[0][:, -1]

    return dict(
        prefill=jax.jit(lambda p, b, k: jm.prefill(rt, cfg, p, b, k)),
        decode=jax.jit(lambda p, b, k: jm.decode_step(rt, cfg, p, b, k)),
        last_hidden=jax.jit(last_hidden),
        decode_hidden=jax.jit(decode_hidden))


@pytest.fixture(scope="module")
def models(jx):
    """name → the reduced config (port and reference), the reference's
    parameters (numpy and JAX), the port's at q = 1 and 4, and the
    reference's jitted functions; built at first use."""
    built = {}

    def get(name):
        if name not in built:
            jax = jx["jax"]
            arch, fields = ARCHS[name]
            cfg = dataclasses.replace(get_arch(arch).reduced(), **fields)
            jcfg = dataclasses.replace(jx["get_arch"](arch).reduced(),
                                       **fields)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            params = jax.tree.map(np.asarray, jx["jm"].init_params(
                jcfg, jax.random.PRNGKey(0)))
            built[name] = dict(
                cfg=cfg, jcfg=jcfg, np=params,
                jax=jax.tree.map(jx["jnp"].asarray, params),
                port={q: convert.lm_params(params, q=q, device="cpu")
                      for q in QS},
                fn=_jfns(jx, jcfg))
        return built[name]
    return get


def _prompt(jx, m, b=4, s=PROMPT, seed=0):
    shape = ShapeConfig("t", s, b, "prefill")
    got = make_batch(m["cfg"], shape, _rt(1), seed=seed, device="cpu")
    want = jx["inputs"].make_batch(m["jcfg"], shape, jx["rt"], seed=seed)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    return got, want


def _teacher(m, b=4, n=STEPS):
    return np.random.default_rng(1).integers(0, m["cfg"].vocab, (b, n))


# ---------------------------------------------------------------------------
# layer windows, the backbone, prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,seq", [("gemma3_4b", 4128),
                                      ("gemma3_4b", 100),
                                      ("stablelm_1_6b", 4128)])
def test_layer_windows_match_jax(jx, arch, seq):
    want = jx["jm"].layer_windows(jx["get_arch"](arch), seq)
    got = tm.layer_windows(get_arch(arch), seq)
    np.testing.assert_array_equal(np.asarray(got), want)
    if arch == "gemma3_4b" and seq == 4128:
        assert [i for i, w in enumerate(got) if w == seq] == [5, 11, 17, 23,
                                                             29]


@pytest.mark.parametrize("name", GEMMAS)
@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_backbone_matches_jax(jx, models, impl, name):
    """The stack and final norm on the same embedded prompt (24 positions,
    so the window of 16 masks)."""
    m = models(name)
    jnp = jx["jnp"]
    _, jb = _prompt(jx, m, b=2, s=24)
    x = jx["jm"]._embed_tokens(jx["rt"], m["jcfg"], m["jax"], jb["tokens"],
                               jx["jax"].random.PRNGKey(0))
    want, _, _ = jx["jm"]._backbone(jx["rt"], m["jcfg"], m["jax"], x,
                                    x.shape[1])
    got = tm._backbone(_rt(1, attn_impl=impl, attn_chunk=8), m["cfg"],
                       m["port"][1],
                       torch.from_numpy(np.array(x.astype(jnp.float32)))
                       .to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _assert_rel(got, want, HIDDEN_REL)


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_matches_jax(jx, models, name, q):
    """The next tokens wherever the reference's margin decides them, and
    the bf16 KV cache (L, B, S, Hkv, dh)."""
    m = models(name)
    key = jx["jax"].random.PRNGKey(0)
    tb, jb = _prompt(jx, m, s=16)
    want, jcache = m["fn"]["prefill"](m["jax"], jb, key)
    got, cache = tm.prefill(_rt(q), m["cfg"], m["port"][q], tb, _gen())
    cfg = m["cfg"]
    for k in ("k", "v"):
        assert cache[k].dtype == torch.bfloat16
        assert tuple(cache[k].shape) == jcache[k].shape == (
            cfg.n_layers, 4, 16, cfg.n_kv, cfg.head_dim)
        _assert_rel(cache[k], jcache[k], HIDDEN_REL)
    h = m["fn"]["last_hidden"](m["jax"], jb["tokens"], key)
    _assert_tokens(got.numpy(), np.asarray(want),
                   _jax_logits(jx, m["jax"]["embed"], h))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _jax_prefilled(jx, m, b=4):
    """The reference's prefill of a PROMPT-token prompt, put into a zero
    cache of PROMPT + STEPS positions as ``repro/launch/serve.py`` does."""
    jax = jx["jax"]
    _, jb = _prompt(jx, m, b=b)
    _, kv = m["fn"]["prefill"](m["jax"], jb, jax.random.PRNGKey(0))
    cache = jx["jm"].init_cache(jx["rt"], m["jcfg"], b, PROMPT + STEPS)
    return {k: jax.lax.dynamic_update_slice_in_dim(cache[k], kv[k], 0,
                                                   axis=2) for k in cache}


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_steps_match_jax(jx, models, name, q):
    """Four teacher-forced decode steps after a prefill: each step starts
    from the reference's cache; the port writes its new K/V in place,
    and the cache and the tokens must match the reference's functional
    step."""
    jax, jnp = jx["jax"], jx["jnp"]
    m = models(name)
    jcache = _jax_prefilled(jx, m)
    teacher = _teacher(m)
    for t in range(STEPS):
        pos, key = PROMPT + t, jax.random.PRNGKey(t)
        token = jnp.asarray(teacher[:, t], jnp.int32)
        want, jnext = m["fn"]["decode"](
            m["jax"], {"token": token, "pos": jnp.asarray(pos, jnp.int32),
                       "cache": jcache}, key)
        cache = _cache_t(jcache, jnp)
        got, nxt = tm.decode_step(_rt(q), m["cfg"], m["port"][q],
                                  {"token": torch.from_numpy(teacher[:, t]),
                                   "pos": pos, "cache": cache}, _gen(t))
        assert nxt is cache, "the dense decode step writes in place"
        for k in ("k", "v"):
            _assert_rel(nxt[k], jnext[k], HIDDEN_REL)
        hj = m["fn"]["decode_hidden"](m["jax"], token, jcache,
                                      jnp.asarray(pos, jnp.int32), key)
        _assert_tokens(got.numpy(), np.asarray(want),
                       _jax_logits(jx, m["jax"]["embed"], hj))
        jcache = jnext


@pytest.fixture(scope="module")
def jax_q4(models, tmp_path_factory):
    """The reference's prefill and four teacher-forced decode steps of the
    two gemma3 variants at q = 4: one subprocess with 4 forced host
    devices, where the decode attention is a shard_map over 4 cache
    shards."""
    tmp = tmp_path_factory.mktemp("dense_q4")
    for name in GEMMAS:
        m = models(name)
        np.savez(tmp / f"{name}_in.npz", teacher=_teacher(m),
                 **{"p/" + "/".join(path): leaf for path, leaf in
                    _flatten(m["np"])})
    script = textwrap.dedent(f"""
        import dataclasses
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs.base import get_arch
        from repro.configs.inputs import make_batch
        from repro.configs.base import ShapeConfig
        from repro.launch.mesh import make_mesh_for
        from repro.models import model as jm
        from repro.sharding.api import Runtime
        rt = Runtime(mesh=make_mesh_for(4, 4), batch_axes=("data",),
                     attn_chunk=32, loss_chunk=16)
        for name, glob in (("gemma3", {{}}),
                           ("gemma3_global2", {{"global_every": 2}})):
            cfg = dataclasses.replace(get_arch("gemma3_4b").reduced(),
                                      **glob)
            d = np.load({str(tmp)!r} + f"/{{name}}_in.npz")
            p = {{}}
            for k in d.files:
                if k.startswith("p/"):
                    node, parts = p, k[2:].split("/")
                    for part in parts[:-1]:
                        node = node.setdefault(part, {{}})
                    node[parts[-1]] = jnp.asarray(d[k])
            jb = make_batch(cfg, ShapeConfig("t", {PROMPT}, 4, "prefill"),
                            rt, seed=0)
            tok, kv = jax.jit(lambda p, b, k: jm.prefill(rt, cfg, p, b, k))(
                p, jb, jax.random.PRNGKey(0))
            cache = jm.init_cache(rt, cfg, 4, {PROMPT + STEPS})
            cache = {{k: jax.lax.dynamic_update_slice_in_dim(
                cache[k], kv[k], 0, axis=2) for k in cache}}
            dec = jax.jit(lambda p, b, k: jm.decode_step(rt, cfg, p, b, k))
            out = {{"prefill_tok": np.asarray(tok)}}
            for t in range({STEPS}):
                for k in cache:
                    out[f"cache{{t}}_{{k}}"] = np.asarray(
                        cache[k].astype(jnp.float32))
                token = jnp.asarray(d["teacher"][:, t], jnp.int32)
                tok, cache = dec(p, {{"token": token,
                                      "pos": jnp.asarray({PROMPT} + t,
                                                         jnp.int32),
                                      "cache": cache}},
                                 jax.random.PRNGKey(t))
                out[f"tok{{t}}"] = np.asarray(tok)
            for k in cache:
                out[f"cache{STEPS}_{{k}}"] = np.asarray(
                    cache[k].astype(jnp.float32))
            np.savez({str(tmp)!r} + f"/{{name}}_out.npz", **out)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {name: dict(np.load(tmp / f"{name}_out.npz")) for name in GEMMAS}


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", GEMMAS)
def test_decode_matches_jax_at_q4(jx, models, jax_q4, name):
    """The port at q = 4 against the reference's 4-device run: each of the
    four steps starts from the reference's cache; the new cache and the
    tokens must match (tokens where the single-device reference's margin
    on the same step decides them)."""
    jax, jnp = jx["jax"], jx["jnp"]
    m, ref4 = models(name), jax_q4[name]
    tb, _ = _prompt(jx, m)
    got, cache = tm.prefill(_rt(4), m["cfg"], m["port"][4], tb, _gen())
    jcache = _jax_prefilled(jx, m)
    for k in ("k", "v"):
        _assert_rel(cache[k], ref4[f"cache0_{k}"][:, :, :PROMPT],
                    HIDDEN_REL)
    teacher = _teacher(m)
    for t in range(STEPS):
        pos = PROMPT + t
        cache = {k: torch.from_numpy(ref4[f"cache{t}_{k}"])
                 .to(torch.bfloat16) for k in ("k", "v")}
        got, nxt = tm.decode_step(_rt(4), m["cfg"], m["port"][4],
                                  {"token": torch.from_numpy(teacher[:, t]),
                                   "pos": pos, "cache": cache}, _gen(t))
        for k in ("k", "v"):
            _assert_rel(nxt[k], ref4[f"cache{t + 1}_{k}"], HIDDEN_REL)
        token = jnp.asarray(teacher[:, t], jnp.int32)
        hj = m["fn"]["decode_hidden"](m["jax"], token, jcache,
                                      jnp.asarray(pos, jnp.int32),
                                      jax.random.PRNGKey(t))
        _assert_tokens(got.numpy(), ref4[f"tok{t}"],
                       _jax_logits(jx, m["jax"]["embed"], hj))
        _, jcache = m["fn"]["decode"](
            m["jax"], {"token": token, "pos": jnp.asarray(pos, jnp.int32),
                       "cache": jcache}, jax.random.PRNGKey(t))


@pytest.mark.parametrize("q", QS)
def test_serve_matches_jax_loop(jx, models, q):
    """``serve(device="cpu")`` against the reference's prefill + decode
    loop (``repro/launch/serve.py``) on serve's own parameters and
    prompt."""
    jax, jnp = jx["jax"], jx["jnp"]
    m = models("gemma3")
    b, s, n_gen = 2, 16, 4
    res = serve("gemma3_4b", batch=b, prompt_len=s, gen_tokens=n_gen,
                model_parallel=q, seed=3, device="cpu")
    assert res.tokens.shape == (b, n_gen) and res.tokens.dtype == np.int64
    assert len(res.step_seconds) == n_gen - 1 and res.prefill_seconds > 0
    params = tm.init_params(m["cfg"], 3, device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jb = jx["inputs"].make_batch(m["jcfg"], ShapeConfig("serve", s, b,
                                                        "prefill"),
                                 jx["rt"], 3)
    fn = m["fn"]
    key = jax.random.PRNGKey(3)
    tok, kv = fn["prefill"](jp, jb, key)
    logits = [_jax_logits(jx, jp["embed"],
                          fn["last_hidden"](jp, jb["tokens"], key))]
    want = [np.asarray(tok)]
    cache = jx["jm"].init_cache(jx["rt"], m["jcfg"], b, s + n_gen)
    cache = {k: jax.lax.dynamic_update_slice_in_dim(cache[k], kv[k], 0,
                                                    axis=2) for k in cache}
    for i in range(n_gen - 1):
        key = jax.random.PRNGKey(i)
        pos = jnp.asarray(s + i, jnp.int32)
        hj = fn["decode_hidden"](jp, tok, cache, pos, key)
        tok, cache = fn["decode"](jp, {"token": tok, "pos": pos,
                                       "cache": cache}, key)
        logits.append(_jax_logits(jx, jp["embed"], hj))
        want.append(np.asarray(tok))
    _assert_tokens(res.tokens.T, np.stack(want), np.stack(logits))
    for k in ("k", "v"):
        _assert_rel(res.cache[k], cache[k], HIDDEN_REL)


def test_serve_secure_modes_agree():
    base = serve("gemma3_4b", batch=2, prompt_len=8, gen_tokens=3,
                 model_parallel=4, seed=1, device="cpu")
    other = serve("gemma3_4b", batch=2, prompt_len=8, gen_tokens=3,
                  model_parallel=4, seed=1, device="cpu",
                  secure_mode="ring_masks")
    np.testing.assert_array_equal(other.tokens, base.tokens)


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_matches_forward(models, name, q):
    """The port's own consistency, as ``tests/test_decode_consistency.py``
    checks the reference's: greedy tokens of the full forward at every
    position against teacher-forced decode from an empty cache, in at
    least 95% of the positions.  24 positions, so gemma3's window of 16
    masks the later ones."""
    m = models(name)
    cfg, params, rt = m["cfg"], m["port"][q], _rt(q)
    b, s = 2, 24
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s)))
    x = tm._embed_tokens(rt, cfg, params, tokens, _gen())
    h = tm._backbone(rt, cfg, params, x)
    full = torch.stack([vocab_parallel_greedy(rt, params["embed"], h[:, t])
                        for t in range(s)], 1)
    cache = tm.init_cache(rt, cfg, b, s, device="cpu")
    dec = []
    for t in range(s):
        tok, cache = tm.decode_step(rt, cfg, params,
                                    {"token": tokens[:, t], "pos": t,
                                     "cache": cache}, _gen(t))
        dec.append(tok)
    assert (full == torch.stack(dec, 1)).float().mean() >= 0.95


# ---------------------------------------------------------------------------
# attn_impl
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", GEMMAS)
def test_attn_impls_agree(models, name):
    """``"kernel"`` (the kernels' plain versions here) and
    ``"reference"`` give the same prefill within the hidden tolerance and
    the same decode-step cache and output."""
    m = models(name)
    cfg, params = m["cfg"], m["port"][4]
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 24)))
    x = tm._embed_tokens(_rt(4), cfg, params, tokens, _gen())
    hk = tm._backbone(_rt(4), cfg, params, x)
    hr = tm._backbone(_rt(4, attn_impl="reference", attn_chunk=8), cfg,
                      params, x)
    _assert_rel(hk, hr, HIDDEN_REL)
    outs = []
    for impl in ("kernel", "reference"):
        cache = tm.init_cache(_rt(4), cfg, 2, 24, device="cpu")
        for t in range(20):
            tok, cache = tm.decode_step(_rt(4, attn_impl=impl), cfg, params,
                                        {"token": tokens[:, t], "pos": t,
                                         "cache": cache}, _gen(t))
        outs.append((tok, cache))
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    for k in ("k", "v"):
        _assert_rel(outs[0][1][k], outs[1][1][k], HIDDEN_REL)


@pytest.mark.parametrize("kw,exc", [
    (dict(attn_impl="pallas"), ValueError),
    (dict(attn_chunk=0), ValueError),
    (dict(loss_chunk=0), ValueError)])
def test_runtime_rejects_unknown_and_unported_settings(kw, exc):
    with pytest.raises(exc, match=next(iter(kw))):
        Runtime(**kw)


def test_decode_needs_shards_of_equal_length(models):
    m = models("gemma3")
    cache = tm.init_cache(_rt(4), m["cfg"], 2, 10, device="cpu")
    with pytest.raises(ValueError, match="party shards"):
        tm.decode_step(_rt(4), m["cfg"], m["port"][4],
                       {"token": torch.zeros(2, dtype=torch.int64),
                        "pos": 3, "cache": cache}, _gen())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _reset():
    for lib in (fa.KERNEL, da.KERNEL, ss.KERNEL, vg.KERNEL):
        lib.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("name", GEMMAS)
def test_cuda_prefill_and_decode_launch_once_per_layer(cuda_device, name):
    """A reduced prefill launches ``flash_attention`` once per layer and a
    decode step ``decode_attention`` once per layer (over all q = 4
    shards), nothing else; both paths agree with ``attn_impl=
    "reference"`` on the card."""
    arch, fields = ARCHS[name]
    cfg = dataclasses.replace(get_arch(arch).reduced(), **fields)
    params = tm.init_params(cfg, 0, device=cuda_device)
    batch = make_batch(cfg, ShapeConfig("t", 64, 2, "prefill"), _rt(4),
                       device=cuda_device)
    n = cfg.n_layers
    with torch.no_grad():
        _reset()
        tok, kv = tm.prefill(_rt(4), cfg, params, batch,
                             mask_generator(0, device=cuda_device))
        torch.cuda.synchronize()
        assert fa.KERNEL.launches == {"flash_attention": n}
        assert not any(da.KERNEL.launches.values())
        cache = tm.init_cache(_rt(4), cfg, 2, 68, device=cuda_device)
        for k in cache:
            cache[k][:, :, :64].copy_(kv[k])
        ref_cache = {k: v.clone() for k, v in cache.items()}
        step = {"token": tok, "pos": 64, "cache": cache}
        tk, _ = tm.decode_step(_rt(4), cfg, params, step,
                               mask_generator(1, device=cuda_device))
        torch.cuda.synchronize()
        assert da.KERNEL.launches == {"decode_attention": n}
        assert fa.KERNEL.launches == {"flash_attention": n}
        assert not any(ss.KERNEL.launches.values())
        assert not any(vg.KERNEL.launches.values())
        tr, _ = tm.decode_step(_rt(4, attn_impl="reference"), cfg, params,
                               {"token": tok, "pos": 64, "cache": ref_cache},
                               mask_generator(1, device=cuda_device))
        for k in cache:
            _assert_rel(cache[k].cpu(), ref_cache[k].cpu(), HIDDEN_REL)
        x = tm._embed_tokens(_rt(4), cfg, params, batch["tokens"],
                             mask_generator(2, device=cuda_device))
        h = tm._backbone(_rt(4), cfg, params, x)
        h_ref = tm._backbone(_rt(4, attn_impl="reference"), cfg, params, x)
        _assert_rel(h.cpu(), h_ref.cpu(), HIDDEN_REL)
        assert tk.shape == tr.shape == (2,)


@pytest.mark.cuda
def test_cuda_serve_runs(cuda_device):
    res = serve("gemma3_4b", batch=2, prompt_len=32, gen_tokens=4,
                model_parallel=4, seed=0, device=cuda_device)
    cfg = get_arch("gemma3_4b").reduced()
    assert res.tokens.shape == (2, 4)
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    assert all(torch.isfinite(v.float()).all() for v in res.cache.values())
    again = serve("gemma3_4b", batch=2, prompt_len=32, gen_tokens=4,
                  model_parallel=4, seed=0, device=cuda_device)
    np.testing.assert_array_equal(again.tokens, res.tokens)
