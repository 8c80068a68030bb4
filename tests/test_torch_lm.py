"""The port's LM serving path (the reduced falcon-mamba: 2 layers, d_model
128, N = 8, vocabulary 512) against the JAX package.

Parameters come from the reference's ``init_params`` and cross with
``convert.lm_params``; tokens come from both packages' ``make_batch`` with
one seed.  The masks of the secure embedding cannot be the reference's
bits (torch generators), so the two packages agree to the mask residue.

Tolerances, with their reasons:

* ``secure_vfl_reduce``: f32 partials within 1e-5 of the plain sum (the
  f32 residue of masks of scale 1); a bf16 partial within one bf16 ulp
  (2⁻⁷ relative), since the residue may tip a rounding.
* embeddings: one bf16 ulp (2⁻⁷ relative), for the same reason; the
  table gradient within 1e-6 (sums of the same bf16 cotangents).
* hidden states, caches and decoded values: 2e-2 of the largest reference
  value, two bf16 ulps (2⁻⁶ ≈ 1.6e-2) and a little over: the frameworks
  round bf16 products and sums at different places, and two layers
  compound it.
* tokens: equal wherever the reference's top-two logit margin exceeds
  ``MARGIN`` = 2⁻⁵ of the largest logit, four bf16 ulps, the most the
  hidden-state tolerance can move a bf16 logit; below it a tie may break
  either way.

The reference runs on one device, so its party count is 1; the port runs
at q = 1 and q = 4 against it.  The greedy head's tie rule and the embed
at q = 4 are also held against the reference at q = 4, run in a
subprocess with 4 forced host devices.  Tests marked ``cuda`` need the
card and skip here.
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

from repro_torch import convert
from repro_torch.configs.base import MoESpec, ShapeConfig, SSMSpec, get_arch
from repro_torch.configs.inputs import make_batch
from repro_torch.core.bum import secure_vfl_reduce
from repro_torch.core.secure_agg import mask_generator
from repro_torch.kernels import selective_scan as ss
from repro_torch.launch.serve import serve
from repro_torch.models import model as tm
from repro_torch.sharding.api import Runtime
from repro_torch.vfl.embed import secure_vocab_embed
from repro_torch.vfl.heads import vocab_parallel_greedy

REPO = pathlib.Path(__file__).resolve().parents[1]
ULP = 2.0 ** -7                  # one bf16 ulp, relative
HIDDEN_REL = 2e-2
MARGIN = 2.0 ** -5
QS = [1, 4]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype("float32"), np.float32)


def _assert_rel(got, want, rel):
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _assert_tokens(got, want, logits, rel=MARGIN):
    """Tokens equal wherever the reference's top-two logit margin exceeds
    ``rel`` of its largest logit (below it a tie may break either way)."""
    top = np.sort(logits, axis=-1)[..., -2:]
    decided = top[..., 1] - top[..., 0] > rel * np.abs(logits).max()
    assert decided.mean() >= 0.25, "too few decided tokens to compare"
    np.testing.assert_array_equal(np.asarray(got)[decided],
                                  np.asarray(want)[decided])


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


@pytest.fixture(scope="module")
def lm(jx):
    """The reduced falcon-mamba: config, the reference's parameters
    (numpy and JAX) and the port's at q = 1 and 4."""
    jax = jx["jax"]
    cfg = get_arch("falcon_mamba_7b").reduced()
    jcfg = jx["get_arch"]("falcon_mamba_7b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = jax.tree.map(np.asarray,
                          jx["jm"].init_params(jcfg, jax.random.PRNGKey(0)))
    return dict(cfg=cfg, jcfg=jcfg, np=params,
                jax=jax.tree.map(jx["jnp"].asarray, params),
                port={q: convert.lm_params(params, q=q, device="cpu")
                      for q in QS})


def _rt(q, **kw):
    return Runtime(model_size=q, **kw)


def _gen(seed=0):
    return mask_generator(seed, device="cpu")


# ---------------------------------------------------------------------------
# BUM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,faithful", [("two_tree", False),
                                           ("two_tree", True),
                                           ("ring_masks", False)])
@pytest.mark.parametrize("q", [1, 3, 4])
def test_secure_vfl_reduce_forward_is_the_sum(mode, faithful, q):
    partial = torch.from_numpy(np.random.default_rng(q).standard_normal(
        (q, 3, 5)).astype(np.float32))
    out = secure_vfl_reduce(partial, _gen(), 1.0, faithful, mode)
    assert out.dtype == torch.float32 and out.shape == (3, 5)
    np.testing.assert_allclose(out.numpy(), partial.sum(0).numpy(),
                               atol=1e-5)
    bf = partial.to(torch.bfloat16)
    outb = secure_vfl_reduce(bf, _gen(), 1.0, faithful, mode)
    assert outb.dtype == torch.bfloat16
    want = bf.float().sum(0)
    assert (outb.float() - want).abs().max() <= ULP * want.abs().max()


@pytest.mark.parametrize("mode", ["two_tree", "ring_masks"])
def test_secure_vfl_reduce_backward_gives_every_party_theta(mode):
    rng = np.random.default_rng(1)
    partial = torch.from_numpy(rng.standard_normal((4, 6)).astype(
        np.float32)).requires_grad_()
    theta = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    out = secure_vfl_reduce(partial, _gen(), 1.0, False, mode)
    (g,) = torch.autograd.grad(out, partial, theta)
    assert g.shape == partial.shape
    for party in range(4):
        assert torch.equal(g[party], theta)


def test_secure_vfl_reduce_rejects_unknown_mode():
    with pytest.raises(ValueError):
        secure_vfl_reduce(torch.ones((2, 3)), _gen(), mode="ring")


# ---------------------------------------------------------------------------
# the secure embedding and the greedy head
# ---------------------------------------------------------------------------

def _jax_rt(jx, **kw):
    return dataclasses.replace(jx["rt"], **kw)


@pytest.mark.parametrize("mode", ["two_tree", "ring_masks"])
@pytest.mark.parametrize("q", QS)
def test_secure_vocab_embed_matches_jax(jx, lm, mode, q):
    from repro.vfl.embed import secure_vocab_embed as jembed
    tokens = np.random.default_rng(2).integers(0, lm["cfg"].vocab, (2, 9))
    want = jembed(_jax_rt(jx, secure_mode=mode), lm["jax"]["embed"],
                  jx["jnp"].asarray(tokens, jx["jnp"].int32),
                  jx["jax"].random.PRNGKey(1))
    got = secure_vocab_embed(_rt(q, secure_mode=mode),
                             lm["port"][q]["embed"],
                             torch.from_numpy(tokens), _gen())
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 9, 128)
    np.testing.assert_allclose(_np(got), _np(want), rtol=ULP, atol=1e-7)


@pytest.mark.parametrize("q", QS)
def test_secure_vocab_embed_grad_matches_jax(jx, lm, q):
    """∂/∂table of Σ embed(tokens)·ct: jax.grad through the reference's
    custom VJP at q = 1, torch.autograd through BUM at q."""
    from repro.vfl.embed import secure_vocab_embed as jembed
    jax, jnp = jx["jax"], jx["jnp"]
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, lm["cfg"].vocab, (2, 7))
    tokens[1, :3] = tokens[0, 2]                 # repeated rows accumulate
    ct = rng.standard_normal((2, 7, 128)).astype(np.float32)

    def jloss(table):
        out = jembed(jx["rt"], table, jnp.asarray(tokens, jnp.int32),
                     jax.random.PRNGKey(1))
        return jnp.sum(out.astype(jnp.float32) * ct)

    want = jax.grad(jloss)(lm["jax"]["embed"])
    table = lm["port"][q]["embed"].clone().requires_grad_()
    out = secure_vocab_embed(_rt(q), table, torch.from_numpy(tokens), _gen())
    (got,) = torch.autograd.grad((out.float() * torch.from_numpy(ct)).sum(),
                                 table)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_plain_embed_matches_jax(jx, lm):
    tokens = np.random.default_rng(4).integers(0, lm["cfg"].vocab, (2, 5))
    want = jx["jm"]._embed_tokens(_jax_rt(jx, secure_embed=False),
                                  lm["jcfg"], lm["jax"],
                                  jx["jnp"].asarray(tokens, jx["jnp"].int32),
                                  jx["jax"].random.PRNGKey(0))
    got = tm._embed_tokens(_rt(4, secure_embed=False), lm["cfg"],
                           lm["port"][4], torch.from_numpy(tokens), _gen())
    np.testing.assert_array_equal(_np(got), _np(want))


def _jax_logits(jx, table, h):
    jnp = jx["jnp"]
    return np.asarray((h.astype(jnp.bfloat16) @ table.astype(jnp.bfloat16).T
                       ).astype(jnp.float32))


@pytest.mark.parametrize("q", QS)
def test_greedy_matches_jax(jx, lm, q):
    from repro.vfl.heads import vocab_parallel_greedy as jgreedy
    h = np.random.default_rng(5).standard_normal((64, 128)).astype(
        np.float32)
    want = np.asarray(jgreedy(jx["rt"], lm["jax"]["embed"],
                              jx["jnp"].asarray(h)))
    got = vocab_parallel_greedy(_rt(q), lm["port"][q]["embed"],
                                torch.from_numpy(h))
    assert got.dtype == torch.int64 and got.shape == (64,)
    # the same h: the logits differ by bf16 rounding only (two ulps)
    _assert_tokens(got.numpy(), want,
                   _jax_logits(jx, lm["jax"]["embed"], jx["jnp"].asarray(h)),
                   rel=2 * ULP)


def _tie_case(table):
    """Rows 5 and 300 (party blocks 0 and 2 of 4) made equal, and h along
    them, so both reach the maximum: a tie across two blocks."""
    table = np.array(table)
    table[300] = table[5]
    h = np.stack([20.0 * table[5], -20.0 * table[7]])
    return table, h.astype(np.float32)


@pytest.fixture(scope="module")
def jax_q4(lm, tmp_path_factory):
    """The reference's greedy head and secure embed at q = 4: one
    subprocess with 4 forced host devices (the test process keeps its one
    device)."""
    tmp = tmp_path_factory.mktemp("jax_q4")
    table, h = _tie_case(lm["np"]["embed"])
    tokens = np.random.default_rng(6).integers(0, lm["cfg"].vocab, (2, 9))
    np.savez(tmp / "in.npz", table=table, h=h, embed=lm["np"]["embed"],
             tokens=tokens)
    script = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.launch.mesh import make_mesh_for
        from repro.sharding.api import Runtime
        from repro.vfl.embed import secure_vocab_embed
        from repro.vfl.heads import vocab_parallel_greedy
        d = np.load({str(tmp / "in.npz")!r})
        out = {{}}
        for mode in ("two_tree", "ring_masks"):
            rt = Runtime(mesh=make_mesh_for(4, 4), batch_axes=("data",),
                         secure_mode=mode)
            out["greedy"] = np.asarray(vocab_parallel_greedy(
                rt, jnp.asarray(d["table"]), jnp.asarray(d["h"])))
            out["embed_" + mode] = np.asarray(secure_vocab_embed(
                rt, jnp.asarray(d["embed"]),
                jnp.asarray(d["tokens"], jnp.int32),
                jax.random.PRNGKey(1)).astype(jnp.float32))
        np.savez({str(tmp / "out.npz")!r}, **out)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"), table=table, h=h, tokens=tokens)


def test_greedy_tie_across_blocks_matches_jax(jx, jax_q4):
    """A tie across two party blocks goes to the largest candidate id at
    q = 4 and to the first maximum at q = 1, in both packages."""
    from repro.vfl.heads import vocab_parallel_greedy as jgreedy
    table, h = jax_q4["table"], jax_q4["h"]
    np.testing.assert_array_equal(jax_q4["greedy"][0], 300)
    got4 = vocab_parallel_greedy(_rt(4), torch.from_numpy(table),
                                 torch.from_numpy(h))
    np.testing.assert_array_equal(got4.numpy(), jax_q4["greedy"])
    want1 = np.asarray(jgreedy(jx["rt"], jx["jnp"].asarray(table),
                               jx["jnp"].asarray(h)))
    got1 = vocab_parallel_greedy(_rt(1), torch.from_numpy(table),
                                 torch.from_numpy(h))
    assert want1[0] == 5
    np.testing.assert_array_equal(got1.numpy(), want1)


@pytest.mark.parametrize("mode", ["two_tree", "ring_masks"])
def test_secure_vocab_embed_matches_jax_at_q4(lm, jax_q4, mode):
    got = secure_vocab_embed(_rt(4, secure_mode=mode),
                             lm["port"][4]["embed"],
                             torch.from_numpy(jax_q4["tokens"]), _gen())
    np.testing.assert_allclose(_np(got), jax_q4["embed_" + mode], rtol=ULP,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# the model: prefill, decode_step, serve
# ---------------------------------------------------------------------------

def _prompt(jx, lm, b=2, s=16, seed=0):
    shape = ShapeConfig("t", s, b, "prefill")
    got = make_batch(lm["cfg"], shape, _rt(1), seed=seed, device="cpu")
    want = jx["inputs"].make_batch(lm["jcfg"], shape, jx["rt"], seed=seed)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    return got, want


def test_make_batch_matches_jax(jx, lm):
    _prompt(jx, lm, 3, 11, seed=7)
    shape = ShapeConfig("t", 12, 3, "decode")
    got = make_batch(lm["cfg"], shape, _rt(1), seed=7, device="cpu")
    want = jx["inputs"].make_batch(lm["jcfg"], shape, jx["rt"], seed=7)
    np.testing.assert_array_equal(got["token"].numpy(),
                                  np.asarray(want["token"]))
    assert got["pos"] == int(want["pos"]) == 6
    for k in ("conv", "h"):
        assert tuple(got["cache"][k].shape) == want["cache"][k].shape
        assert not got["cache"][k].any()
    shape = ShapeConfig("t", 4, 2, "train")
    got = make_batch(lm["cfg"], shape, _rt(1), seed=7, device="cpu")
    want = jx["inputs"].make_batch(lm["jcfg"], shape, jx["rt"], seed=7)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("impl", [("kernel", "pallas"),
                                  ("reference", "reference")])
def test_backbone_matches_jax(jx, lm, impl):
    """The stack and final norm on the same embedded prompt."""
    jnp = jx["jnp"]
    _, jb = _prompt(jx, lm)
    x = jx["jm"]._embed_tokens(jx["rt"], lm["jcfg"], lm["jax"], jb["tokens"],
                               jx["jax"].random.PRNGKey(0))
    want, _, _ = jx["jm"]._backbone(_jax_rt(jx, scan_impl=impl[1]),
                                    lm["jcfg"], lm["jax"], x, x.shape[1])
    got = tm._backbone(_rt(1, scan_impl=impl[0]), lm["cfg"], lm["port"][1],
                       torch.from_numpy(np.array(x.astype(jnp.float32)))
                       .to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _assert_rel(got, want, HIDDEN_REL)


@pytest.fixture(scope="module")
def jfn(jx, lm):
    """The reference's model functions, jitted once for the reduced
    config: ``prefill``, ``decode_step``, the prefill's last normed hidden
    state and a decode step's normed hidden state (``decode_step``
    returns the token only)."""
    jax, jm, rt, cfg = jx["jax"], jx["jm"], jx["rt"], lm["jcfg"]

    def decode_hidden(p, token, cache, key):
        x = jm._embed_tokens(rt, cfg, p, token[:, None], key)[:, 0]
        for i in range(cfg.n_layers):
            x, _, _ = jm._block_decode(
                rt, cfg, "ssm", jax.tree.map(lambda a: a[i], p["stack"]), x,
                jax.tree.map(lambda a: a[i], cache), 0, None)
        return jm.rms_norm(x, p["final_norm"])

    def last_hidden(p, tokens, key):
        x = jm._embed_tokens(rt, cfg, p, tokens, key)
        return jm._backbone(rt, cfg, p, x, x.shape[1])[0][:, -1]

    return dict(
        prefill=jax.jit(lambda p, b, k: jm.prefill(rt, cfg, p, b, k)),
        decode=jax.jit(lambda p, b, k: jm.decode_step(rt, cfg, p, b, k)),
        last_hidden=jax.jit(last_hidden),
        decode_hidden=jax.jit(decode_hidden))


@pytest.mark.parametrize("q", QS)
def test_prefill_matches_jax(jx, lm, jfn, q):
    """Same next tokens as the reference's prefill wherever its margin
    decides them, and no cache for the SSM family in either (C.R3)."""
    key = jx["jax"].random.PRNGKey(0)
    tb, jb = _prompt(jx, lm, b=4)
    want, jcache = jfn["prefill"](lm["jax"], jb, key)
    got, cache = tm.prefill(_rt(q), lm["cfg"], lm["port"][q], tb, _gen())
    assert cache is None and jcache is None
    h = jfn["last_hidden"](lm["jax"], jb["tokens"], key)
    _assert_tokens(got.numpy(), np.asarray(want),
                   _jax_logits(jx, lm["jax"]["embed"], h))


@pytest.mark.parametrize("q", QS)
def test_decode_steps_match_jax(jx, lm, jfn, q):
    """Four teacher-forced decode steps from the zero state: the states
    within the hidden tolerance and the tokens wherever the reference's
    margin decides them; each step starts from the reference's state."""
    jax, jnp = jx["jax"], jx["jnp"]
    tb, jb = _prompt(jx, lm, b=4, s=4)
    jcache = jx["jm"].init_cache(jx["rt"], lm["jcfg"], 4, 8)
    cache = tm.init_cache(_rt(q), lm["cfg"], 4, 8, device="cpu")
    for k in ("conv", "h"):
        assert str(cache[k].dtype).split(".")[1] == str(jcache[k].dtype)
    for t in range(4):
        token, key = jb["tokens"][:, t], jax.random.PRNGKey(t)
        want, jnext = jfn["decode"](
            lm["jax"], {"token": token, "pos": jnp.asarray(t, jnp.int32),
                        "cache": jcache}, key)
        cache = {k: torch.from_numpy(np.array(jcache[k].astype(jnp.float32)))
                 .to(cache[k].dtype) for k in cache}
        got, nxt = tm.decode_step(_rt(q), lm["cfg"], lm["port"][q],
                                  {"token": tb["tokens"][:, t], "pos": t,
                                   "cache": cache}, _gen(t))
        for k in ("conv", "h"):
            assert nxt[k].dtype == cache[k].dtype
            _assert_rel(nxt[k], jnext[k], HIDDEN_REL)
        hj = jfn["decode_hidden"](lm["jax"], token, jcache, key)
        _assert_tokens(got.numpy(), np.asarray(want),
                       _jax_logits(jx, lm["jax"]["embed"], hj))
        jcache = jnext


@pytest.mark.parametrize("q", QS)
def test_serve_matches_jax_loop(jx, lm, jfn, q):
    """``serve(device="cpu")`` against the reference's prefill +
    decode_step loop (``repro/launch/serve.py``) on serve's own
    parameters and prompt."""
    jax, jnp = jx["jax"], jx["jnp"]
    b, s, n_gen = 2, 16, 5
    res = serve("falcon_mamba_7b", batch=b, prompt_len=s, gen_tokens=n_gen,
                model_parallel=q, seed=3, device="cpu")
    assert res.tokens.shape == (b, n_gen) and res.tokens.dtype == np.int64
    assert len(res.step_seconds) == n_gen - 1 and res.prefill_seconds > 0
    params = tm.init_params(lm["cfg"], 3, device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jb = jx["inputs"].make_batch(lm["jcfg"], ShapeConfig("serve", s, b,
                                                         "prefill"),
                                 jx["rt"], 3)
    key = jax.random.PRNGKey(3)
    tok, _ = jfn["prefill"](jp, jb, key)
    logits = [_jax_logits(jx, jp["embed"],
                          jfn["last_hidden"](jp, jb["tokens"], key))]
    want = [np.asarray(tok)]
    cache = jx["jm"].init_cache(jx["rt"], lm["jcfg"], b, s + n_gen)
    for i in range(n_gen - 1):
        key = jax.random.PRNGKey(i)
        hj = jfn["decode_hidden"](jp, tok, cache, key)
        tok, cache = jfn["decode"](
            jp, {"token": tok, "pos": jnp.asarray(s + i, jnp.int32),
                 "cache": cache}, key)
        logits.append(_jax_logits(jx, jp["embed"], hj))
        want.append(np.asarray(tok))
    _assert_tokens(res.tokens.T, np.stack(want), np.stack(logits))
    for k in ("conv", "h"):
        _assert_rel(res.cache[k], cache[k], HIDDEN_REL)


@pytest.mark.parametrize("mode,faithful", [("ring_masks", False),
                                           ("two_tree", True)])
def test_serve_secure_modes_agree(mode, faithful):
    base = serve("falcon_mamba_7b", batch=2, prompt_len=8, gen_tokens=3,
                 model_parallel=4, seed=1, device="cpu")
    other = serve("falcon_mamba_7b", batch=2, prompt_len=8, gen_tokens=3,
                  model_parallel=4, seed=1, device="cpu", secure_mode=mode,
                  schedule_faithful=faithful)
    np.testing.assert_array_equal(other.tokens, base.tokens)


@pytest.mark.parametrize("q", QS)
def test_decode_matches_forward(lm, q):
    """The port's own consistency, as ``tests/test_decode_consistency.py``
    checks the reference's: greedy tokens of the full forward at every
    position against teacher-forced decode from the zero state."""
    cfg, params, rt = lm["cfg"], lm["port"][q], _rt(q)
    b, s = 2, 16
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


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "whisper_tiny",
                                  "pixtral_12b", "hybrid", "audio", "vlm",
                                  "moe", "dense"])
def test_other_families_raise_naming_a15(lm, arch):
    """Every family is ported (the name is historical): an ``MoESpec``
    config builds, a period config builds its ``periods`` and its list
    cache, an encoder-decoder config (whisper-tiny's, or a one-layer
    "audio" one) its encoder tree and a cache with the cross K/V padded
    to a multiple of q, a VLM config (pixtral-12b's, or a small "vlm"
    one) its ``patch_proj``; unknown ids still raise."""
    if arch.endswith(("_tiny", "_12b")):
        cfg = get_arch(arch).reduced()
        assert cfg.arch_type == ("audio" if arch == "whisper_tiny"
                                 else "vlm")
        res = serve(arch, batch=1, prompt_len=12, gen_tokens=2,
                    model_parallel=2, device="cpu")
        assert res.tokens.shape == (1, 2)
        assert ("xk" in res.cache) == cfg.enc_dec
        return
    cfg_cls, base = type(lm["cfg"]), dict(n_layers=1, d_model=8, n_heads=2,
                                          n_kv=1, d_ff=16, vocab=256)
    cfgs = {
        "moe": cfg_cls(name="moe", arch_type="moe", moe=MoESpec(4, 2, 8),
                       **base),
        "hybrid": cfg_cls(name="hybrid", arch_type="hybrid",
                          period=("ssm_mlp", "attn_mlp"),
                          ssm=SSMSpec(4, 4, 2), **dict(base, n_layers=4)),
        "jamba_v0_1_52b": get_arch("jamba_v0_1_52b").reduced(),
        "audio": cfg_cls(name="audio", arch_type="audio", enc_dec=True,
                         enc_layers=1, enc_seq=4, **base),
        "vlm": cfg_cls(name="vlm", arch_type="vlm", n_patches=2, d_patch=4,
                       **base),
        "dense": cfg_cls(name="dense", arch_type="dense", **base)}
    cfg = cfgs[arch]
    if arch in ("moe", "dense"):
        assert tm.layer_kinds(cfg) == ("attn_" + ("moe" if arch == "moe"
                                                  else "mlp"),)
        params = tm.init_params(cfg, device="cpu")
        assert ("moe" in params["stack"]) == (arch == "moe")
        assert tm.init_cache(_rt(1), cfg, 1, 4, device="cpu")["k"].shape \
            == (1, 1, 4, 1, 4)
        assert get_arch("stablelm_1_6b").arch_type == "dense"
        assert get_arch("qwen3_moe_30b_a3b").arch_type == "moe"
        with pytest.raises(ValueError):
            get_arch("no_such_model")
        return
    if cfg.period is not None:
        assert get_arch("jamba_v0_1_52b").arch_type == "hybrid"
        n_per = cfg.n_layers // len(cfg.period)
        assert tm.layer_kinds(cfg) == tuple(cfg.period) * n_per
        params = tm.init_params(cfg, device="cpu")
        assert "stack" not in params and len(params["periods"]) \
            == len(cfg.period)
        cache = tm.init_cache(_rt(1), cfg, 1, 4, device="cpu")
        assert isinstance(cache, list) and len(cache) == len(cfg.period)
        for kind, block, entry in zip(cfg.period, params["periods"], cache):
            mixer = "attn" if kind.startswith("attn") else "ssm"
            assert mixer in block and block["norm1"].shape[0] == n_per
            assert set(entry) == ({"k", "v"} if mixer == "attn"
                                  else {"conv", "h"})
            assert all(v.shape[0] == n_per for v in entry.values())
        return
    assert tm.layer_kinds(cfg) == ("attn_mlp",)
    params = tm.init_params(cfg, device="cpu")
    cache = tm.init_cache(_rt(3), cfg, 1, 6, device="cpu")
    if arch == "audio":
        assert set(params["stack"]) == {"norm1", "attn", "norm_x", "xattn"}
        assert params["enc_proj"].shape == (16, 8)
        assert params["enc_stack"]["norm1"].shape == (1, 8)
        assert params["enc_norm"].shape == (8,)
        assert cache["xk"].shape == cache["xv"].shape == (1, 1, 6, 1, 4)
    else:
        assert params["patch_proj"].shape == (4, 8)
        assert "mlp" in params["stack"] and set(cache) == {"k", "v"}
    assert cache["k"].shape == (1, 1, 6, 1, 4)


def test_lm_params_rejects_other_trees(lm):
    with pytest.raises(ValueError):
        convert.lm_params(lm["np"], q=3, device="cpu")
    tree = dict(lm["np"], stack={"norm1": 0, "attn": {}})
    with pytest.raises(ValueError, match="not an LM parameter tree"):
        convert.lm_params(tree, q=1, device="cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_prefill_launches_one_scan_per_layer(cuda_device):
    """One reduced-size prefill launches the scan kernel once per layer
    and a decode step never; its hidden states agree with the oracle
    scan's on the card."""
    cfg = get_arch("falcon_mamba_7b").reduced()
    params = tm.init_params(cfg, 0, device=cuda_device)
    batch = make_batch(cfg, ShapeConfig("t", 64, 2, "prefill"), _rt(4),
                       device=cuda_device)
    with torch.no_grad():
        ss.KERNEL.reset_launches()
        tok, cache = tm.prefill(_rt(4), cfg, params, batch,
                                mask_generator(0, device=cuda_device))
        torch.cuda.synchronize()
        assert cache is None and tok.shape == (2,)
        assert ss.KERNEL.launches == {"selective_scan": cfg.n_layers}
        dcache = tm.init_cache(_rt(4), cfg, 2, 65, device=cuda_device)
        tm.decode_step(_rt(4), cfg, params,
                       {"token": tok, "pos": 64, "cache": dcache},
                       mask_generator(1, device=cuda_device))
        torch.cuda.synchronize()
        assert ss.KERNEL.launches == {"selective_scan": cfg.n_layers}
        x = tm._embed_tokens(_rt(4), cfg, params, batch["tokens"],
                             mask_generator(2, device=cuda_device))
        h = tm._backbone(_rt(4), cfg, params, x)
        h_ref = tm._backbone(_rt(4, scan_impl="reference"), cfg, params, x)
        _assert_rel(h.cpu(), h_ref.cpu(), HIDDEN_REL)


@pytest.mark.cuda
def test_cuda_serve_runs(cuda_device):
    res = serve("falcon_mamba_7b", batch=2, prompt_len=32, gen_tokens=4,
                model_parallel=4, seed=0, device=cuda_device)
    cfg = get_arch("falcon_mamba_7b").reduced()
    assert res.tokens.shape == (2, 4)
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    assert all(torch.isfinite(v.float()).all() for v in res.cache.values())
    again = serve("falcon_mamba_7b", batch=2, prompt_len=32, gen_tokens=4,
                  model_parallel=4, seed=0, device=cuda_device)
    np.testing.assert_array_equal(again.tokens, res.tokens)
