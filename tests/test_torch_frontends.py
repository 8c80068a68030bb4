"""The port's continuous-modality frontends against the JAX package: the
reduced whisper-tiny (an encoder-decoder: 2 encoder layers over 32 stub
frames of width 256, 2 decoder blocks of self and cross attention,
d_model 128, 4 heads over 2 of 32, vocabulary 512) and the reduced
pixtral-12b (8 stub patches of width 64 as a prefix before the text,
2 dense layers, rope θ 10⁶), both through ``secure_feature_project``.

Parameters come from the reference's ``init_params`` and cross as numpy
arrays through ``convert.lm_params``; inputs (tokens, frames, patches)
come from both packages' ``make_batch`` with one seed.  The masks cannot
be the reference's bits (torch generators), so the two packages agree to
the mask residue.  The reference runs on one device (its party count 1)
and, for q = 4, in one subprocess with 4 forced host devices shared by
both architectures; it starts with the module's first test and runs
beside the others.  As the reference builds it, whisper's decoder block
has no feed-forward (ROADMAP C.R7).

Tolerances, those of ``tests/test_torch_lm.py`` and
``tests/test_torch_moe.py``, with their reasons:

* ``secure_feature_project`` with its masks off (``mask_scale=0``):
  within one bf16 ulp (2⁻⁷) of the largest reference value, since the
  parties' bf16 partials round at other places than the one-party
  product (at q = 4 against the reference's own 4 partials: to f32
  rounding of their sum, so within one ulp elementwise); under
  ``two_tree`` and ``ring_masks`` the f32 mask residue may tip one more
  rounding: two ulps.  Its BUM gradients within one bf16 ulp of the
  largest reference value: ϑ is cast to the partial's bf16, so each
  party's block gradient is a bf16 product in both packages, rounded
  after sums in another order;
* hidden states and caches within ``HIDDEN_REL`` = 2e-2 of the largest
  reference value (two bf16 ulps and a little over: the frameworks
  round bf16 products and sums at different places);
* tokens equal wherever the reference's top-two logit margin exceeds
  2⁻⁵ of its largest logit (below it a tie may break either way);
* the loss and every leaf's gradient with f32 activations in both
  packages and the plain projections (no mask residue; only the head
  rounds to bf16): the loss within 1e-5, each gradient within
  ``F32_GRAD_REL`` = 2e-3 of the leaf's largest reference value and
  twice ``F32_GRAD_L2`` (4e-4) in relative L2.  The head rounds the
  final hidden state to bf16, so where the two packages' f32 states
  differ by their f32 rounding (1e-6 at pixtral's) an element may round
  to the other bf16 neighbour: that alone moves the head's cotangent,
  and every leaf's gradient, by 1.9e-4 relative L2 at the reduced
  pixtral (measured: the two heads on one hidden state agree exactly),
  against 6e-7 at whisper, where no element tips.

Tests marked ``cuda`` need the card and skip here.
"""
import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from test_torch_lm import HIDDEN_REL, ULP, _assert_rel, _assert_tokens, \
    _jax_logits
from test_torch_moe import F32_GRAD_L2, F32_GRAD_REL

from repro_torch import convert
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.configs.inputs import make_batch, token_split
from repro_torch.core.secure_agg import mask_generator
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels import vfl_grad as vg
from repro_torch.launch import train as ttrain
from repro_torch.launch.serve import serve
from repro_torch.models import model as tm
from repro_torch.optim.tree import leaves_with_path
from repro_torch.sharding.api import Runtime
from repro_torch.vfl.embed import secure_feature_project
from repro_torch.vfl.heads import vocab_parallel_greedy

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["whisper_tiny", "pixtral_12b"]
QS = [1, 4]
B = 4
PROMPT = 16       # prompt positions (pixtral: 8 patches + 8 text tokens)
STEPS = 3         # teacher-forced decode steps after the prefill
CACHE = 20        # decode cache positions (a multiple of 4)
# each architecture's frontend: (projection, input)
FRONTEND = {"whisper_tiny": ("enc_proj", "frames"),
            "pixtral_12b": ("patch_proj", "patches")}


def _rt(q, **kw):
    return Runtime(model_size=q, **dict(dict(attn_chunk=32, loss_chunk=16),
                                        **kw))


def _gen(seed=0):
    return mask_generator(seed, device="cpu")


def _f32(a):
    return np.asarray(a.astype("float32"), np.float32)


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
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_arch as jget_arch
    from repro.models import model as jm
    from repro.sharding.api import single_device_runtime
    from repro.vfl.embed import secure_feature_project as jproject
    return dict(jax=jax, jnp=jnp, jm=jm, inputs=jinputs, Shape=JShape,
                get_arch=jget_arch, project=jproject,
                rt=single_device_runtime(attn_chunk=32, loss_chunk=16))


def _jfns(jx, cfg):
    """The reference's jitted ``prefill`` and ``decode_step``, the normed
    hidden states behind their tokens, and ``train_loss``'s value and
    gradient at f32 activations."""
    jax, jm, rt = jx["jax"], jx["jm"], jx["rt"]
    kind = "attn_cross" if cfg.enc_dec else "attn_mlp"

    def layer(tree, i):
        return jax.tree.map(lambda a: a[i], tree)

    def decode_hidden(p, token, cache, pos, key):
        x = jm._embed_tokens(rt, cfg, p, token[:, None], key)[:, 0]
        for i in range(cfg.n_layers):
            x, _, _ = jm._block_decode(rt, cfg, kind, layer(p["stack"], i),
                                       x, layer(cache, i), pos, None)
        return jm.rms_norm(x, p["final_norm"])

    def hidden(p, batch, key):
        x, enc_out, _ = jm._prepare_inputs(rt, cfg, p, batch, key)
        return jm._backbone(rt, cfg, p, x, x.shape[1], enc_out=enc_out)[0]

    def grad_f32(p, batch):
        # f32 activations and the plain projections (no mask residue)
        saved = jm.ACT_DTYPE
        jm.ACT_DTYPE = jx["jnp"].float32
        try:
            return jax.jit(jax.value_and_grad(lambda p: jm.train_loss(
                dataclasses.replace(rt, secure_embed=False), cfg, p, batch,
                jax.random.PRNGKey(1))))(p)
        finally:
            jm.ACT_DTYPE = saved

    return dict(
        prefill=jax.jit(lambda p, b, k: jm.prefill(rt, cfg, p, b, k)),
        decode=jax.jit(lambda p, b, k: jm.decode_step(rt, cfg, p, b, k)),
        hidden=jax.jit(hidden), decode_hidden=jax.jit(decode_hidden),
        grad_f32=grad_f32)


@pytest.fixture(scope="module")
def models(jx):
    """arch → the reduced config (port and reference), the reference's
    parameters (numpy and JAX), the port's at each q and the reference's
    jitted functions; built at first use."""
    built = {}

    def get(arch):
        if arch not in built:
            jax = jx["jax"]
            cfg, jcfg = get_arch(arch).reduced(), \
                jx["get_arch"](arch).reduced()
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            params = jax.tree.map(np.asarray, jx["jm"].init_params(
                jcfg, jax.random.PRNGKey(0)))
            built[arch] = dict(
                cfg=cfg, jcfg=jcfg, np=params,
                jax=jax.tree.map(jx["jnp"].asarray, params),
                port={q: convert.lm_params(params, q=q, device="cpu")
                      for q in QS},
                fn=_jfns(jx, jcfg))
        return built[arch]
    return get


def _keystr(jx, tree):
    jax = jx["jax"]
    return {jax.tree_util.keystr(kp): v for kp, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(jx, m, mode="prefill", s=PROMPT, b=B, seed=0):
    """Both packages' ``make_batch`` at one seed: (port's, reference's)."""
    got = make_batch(m["cfg"], ShapeConfig("t", s, b, mode), _rt(1),
                     seed=seed, device="cpu")
    want = jx["inputs"].make_batch(m["jcfg"], jx["Shape"]("t", s, b, mode),
                                   jx["rt"], seed=seed)
    return got, want


def _teacher(m, n=STEPS, b=B):
    return np.random.default_rng(1).integers(0, m["cfg"].vocab, (b, n))


def _cache_t(jcache):
    return {k: torch.from_numpy(_f32(v).copy()).to(torch.bfloat16)
            for k, v in jcache.items()}


# ---------------------------------------------------------------------------
# configuration, inputs, parameters, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_layer_kinds_match_jax(jx, arch, reduced):
    cfg, jcfg = get_arch(arch), jx["get_arch"](arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert tm.layer_kinds(cfg) == tuple(jx["jm"].layer_kinds(jcfg)) \
        == ("attn_mlp",) * cfg.n_layers
    assert tm._stacks(cfg, None)[1] == (
        ("attn_cross",) if arch == "whisper_tiny" else ("attn_mlp",))
    for s in (cfg.n_patches + 1, 4096):
        assert token_split(cfg, s) == jx["inputs"].token_split(jcfg, s)


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_matches_jax_bit_for_bit(jx, models, arch, mode):
    """Tokens, labels, frames and patches: the same values from one seed
    (frames and patches bf16 in both)."""
    m = models(arch)
    got, want = _batch(jx, m, mode, seed=5)
    assert set(got) == set(want)
    assert got[FRONTEND[arch][1]].dtype == torch.bfloat16
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_array_equal(got[k].float().numpy(), _f32(w), k)
    assert got["tokens"].shape[1] == token_split(m["cfg"], PROMPT)


def _project_case(arch, m, q):
    proj, feat = FRONTEND[arch]
    cfg = m["cfg"]
    d_in = 2 * cfg.d_model if arch == "whisper_tiny" else cfg.d_patch
    feats = np.random.default_rng(7).standard_normal(
        (2, 5, d_in)).astype(np.float32)
    return m["np"][proj], m["port"][q][proj], feats


@pytest.mark.parametrize("mode", ["off", "two_tree", "ring_masks"])
@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("arch", ARCHS)
def test_secure_feature_project_matches_jax(jx, models, arch, q, mode):
    """(B, S, d_in) features through the parties' projection against the
    reference's at q = 1 and an unmasked f32 product (``off``: masks of
    scale 0)."""
    jnp = jx["jnp"]
    w_np, w, feats = _project_case(arch, models(arch), q)
    kw = dict(mask_scale=0.0) if mode == "off" else dict(secure_mode=mode)
    want = jx["project"](dataclasses.replace(jx["rt"], **kw),
                         jnp.asarray(w_np), jnp.asarray(feats, jnp.bfloat16),
                         jx["jax"].random.PRNGKey(1))
    got = secure_feature_project(_rt(q, **kw), w,
                                 torch.from_numpy(feats).to(torch.bfloat16),
                                 _gen())
    assert got.dtype == torch.bfloat16 and got.shape == (2, 5, w.shape[1])
    ulps = 1 if mode == "off" else 2
    _assert_rel(got, want, ulps * ULP)
    plain = torch.from_numpy(feats).to(torch.bfloat16).float() \
        @ w.to(torch.bfloat16).float()
    _assert_rel(got, plain, ulps * ULP)


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("arch", ARCHS)
def test_secure_feature_project_bum_grad_matches_jax(jx, models, arch, q):
    """∂/∂w and ∂/∂feats of Σ project(w, feats)·ct: jax.grad through the
    reference's custom VJP at q = 1, torch.autograd through BUM at q
    (every party receives ϑ and forms its own block's gradient)."""
    jax, jnp = jx["jax"], jx["jnp"]
    w_np, w, feats = _project_case(arch, models(arch), q)
    ct = np.random.default_rng(8).standard_normal(
        (2, 5, w.shape[1])).astype(np.float32)

    def jloss(w, f):
        out = jx["project"](jx["rt"], w, f, jax.random.PRNGKey(1))
        return jnp.sum(out.astype(jnp.float32) * ct)

    want = jax.grad(jloss, (0, 1))(jnp.asarray(w_np), jnp.asarray(feats))
    wt = w.clone().requires_grad_()
    ft = torch.from_numpy(feats).requires_grad_()
    out = secure_feature_project(_rt(q), wt, ft, _gen())
    got = torch.autograd.grad((out.float() * torch.from_numpy(ct)).sum(),
                              (wt, ft))
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        _assert_rel(g, w_, ULP)


def test_secure_feature_project_needs_whole_party_blocks():
    w = torch.zeros((6, 4))
    with pytest.raises(ValueError, match="party blocks"):
        secure_feature_project(_rt(4), w, torch.zeros((1, 2, 6)), _gen())
    with pytest.raises(ValueError, match="d_in"):
        secure_feature_project(_rt(2), w, torch.zeros((1, 2, 8)), _gen())


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_trees_match_jax(jx, models, arch, q):
    """``init_params``'s tree (key paths, shapes) is the reference's, and
    so is ``init_cache``'s, its cross cache padded to a multiple of q
    (the reduced whisper at enc_seq 30: 30 at q = 1, 32 at q = 4)."""
    m = models(arch)
    cfg, jcfg = m["cfg"], m["jcfg"]
    if arch == "whisper_tiny":
        cfg = dataclasses.replace(cfg, enc_seq=30)
        jcfg = dataclasses.replace(jcfg, enc_seq=30)
    want = _keystr(jx, jx["jm"].init_params(jcfg, jx["jax"].random.PRNGKey(0)))
    got = dict(leaves_with_path(tm.init_params(cfg, 3, device="cpu")))
    assert list(got) == list(want)
    assert all(tuple(got[k].shape) == want[k].shape for k in want)
    assert all(got[k].dtype == torch.float32 for k in got)
    jcache = _keystr(jx, jx["jm"].init_cache(jx["rt"], jcfg, 2, 12))
    cache = tm.init_cache(_rt(q), cfg, 2, 12, device="cpu")
    assert sorted(f"['{k}']" for k in cache) == sorted(jcache)
    for k, v in cache.items():
        assert v.dtype == torch.bfloat16 and not v.any()
        shape = jcache[f"['{k}']"].shape
        if k in ("xk", "xv"):
            shape = shape[:2] + (-(-30 // q) * q,) + shape[3:]
        assert tuple(v.shape) == shape, k


def test_lm_params_rejects_frontend_trees_with_missing_parts(models):
    tree = dict(models("whisper_tiny")["np"])
    del tree["enc_norm"]
    with pytest.raises(ValueError, match="parameter tree"):
        convert.lm_params(tree, q=1, device="cpu")
    tree = dict(models("pixtral_12b")["np"])
    tree["stack"] = dict(tree["stack"], norm_x=0)
    with pytest.raises(ValueError, match="parameter tree"):
        convert.lm_params(tree, q=1, device="cpu")


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(jx, models, arch, q):
    """The next tokens wherever the reference's margin decides them, and
    the bf16 caches: k and v (L, B, S, Hkv, dh), S counting pixtral's
    patches; whisper's xk and xv (L, B, enc_seq, Hkv, dh)."""
    m = models(arch)
    key = jx["jax"].random.PRNGKey(0)
    tb, jb = _batch(jx, m)
    want, jcache = m["fn"]["prefill"](m["jax"], jb, key)
    got, cache = tm.prefill(_rt(q), m["cfg"], m["port"][q], tb, _gen())
    cfg = m["cfg"]
    names = {"k", "v", "xk", "xv"} if cfg.enc_dec else {"k", "v"}
    assert set(cache) == set(jcache) == names
    for k in names:
        length = cfg.enc_seq if k.startswith("x") else PROMPT
        assert cache[k].dtype == torch.bfloat16
        assert tuple(cache[k].shape) == jcache[k].shape == (
            cfg.n_layers, B, length, cfg.n_kv, cfg.head_dim)
        _assert_rel(cache[k], jcache[k], HIDDEN_REL)
    h = m["fn"]["hidden"](m["jax"], jb, key)[:, -1]
    _assert_tokens(got.numpy(), np.asarray(want),
                   _jax_logits(jx, m["jax"]["embed"], h))


def _jax_prefilled(jx, m, cache_len=CACHE):
    """The reference's prefill of the PROMPT-position prompt, each cache
    entry put at the start of ``init_cache``'s as
    ``repro/launch/serve.py:50-56`` does."""
    jax = jx["jax"]
    _, jb = _batch(jx, m)
    _, kv = m["fn"]["prefill"](m["jax"], jb, jax.random.PRNGKey(0))
    cache = jx["jm"].init_cache(jx["rt"], m["jcfg"], B, cache_len)
    return {k: jax.lax.dynamic_update_slice_in_dim(cache[k], kv[k], 0,
                                                   axis=2) for k in cache}


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(jx, models, arch, q):
    """Three teacher-forced decode steps after the prefill, each from the
    reference's cache: the port writes k and v in place, never the cross
    cache (read at enc_seq − 1), and its cache and tokens match the
    reference's step."""
    jax, jnp = jx["jax"], jx["jnp"]
    m = models(arch)
    jcache = _jax_prefilled(jx, m)
    teacher = _teacher(m)
    for t in range(STEPS):
        pos, key = PROMPT + t, jax.random.PRNGKey(t)
        token = jnp.asarray(teacher[:, t], jnp.int32)
        want, jnext = m["fn"]["decode"](
            m["jax"], {"token": token, "pos": jnp.asarray(pos, jnp.int32),
                       "cache": jcache}, key)
        cache = _cache_t(jcache)
        before = {k: v.clone() for k, v in cache.items()}
        got, nxt = tm.decode_step(_rt(q), m["cfg"], m["port"][q],
                                  {"token": torch.from_numpy(teacher[:, t]),
                                   "pos": pos, "cache": cache}, _gen(t))
        assert nxt is cache, "the decode step writes in place"
        for k in cache:
            _assert_rel(nxt[k], jnext[k], HIDDEN_REL)
            if k.startswith("x"):
                assert torch.equal(nxt[k], before[k]), "cross cache written"
        hj = m["fn"]["decode_hidden"](m["jax"], token, jcache,
                                      jnp.asarray(pos, jnp.int32), key)
        _assert_tokens(got.numpy(), np.asarray(want),
                       _jax_logits(jx, m["jax"]["embed"], hj))
        jcache = jnext


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_cross_decode_never_attends_the_padding(jx, models, impl):
    """whisper at enc_seq 30 and q = 4: the port's cross cache is padded
    to 32 positions (4 shards of 8); filled with large junk there, a
    decode step still gives the reference's (unpadded, one device)
    hidden state, since the cross query sits at enc_seq − 1."""
    jax, jnp = jx["jax"], jx["jnp"]
    m = models("whisper_tiny")
    cfg = dataclasses.replace(m["cfg"], enc_seq=30)
    jcfg = dataclasses.replace(m["jcfg"], enc_seq=30)
    jb = jx["inputs"].make_batch(jcfg, jx["Shape"]("t", PROMPT, B, "prefill"),
                                 jx["rt"], seed=0)
    _, kv = jax.jit(lambda p, b, k: jx["jm"].prefill(jx["rt"], jcfg, p, b,
                                                     k))(
        m["jax"], jb, jax.random.PRNGKey(0))
    jcache = jx["jm"].init_cache(jx["rt"], jcfg, B, CACHE)
    jcache = {k: jax.lax.dynamic_update_slice_in_dim(jcache[k], kv[k], 0,
                                                     axis=2) for k in jcache}
    token = jnp.asarray(_teacher(m)[:, 0], jnp.int32)
    pos = jnp.asarray(PROMPT, jnp.int32)
    want = _jfns(jx, jcfg)["decode_hidden"](m["jax"], token, jcache, pos,
                                            jax.random.PRNGKey(0))
    cache = tm.init_cache(_rt(4), cfg, B, CACHE, device="cpu")
    assert cache["xk"].shape[2] == 32
    for k, v in _cache_t(jcache).items():
        cache[k][:, :, :v.shape[2]].copy_(v)
        if k.startswith("x"):
            cache[k][:, :, 30:] = 1e3
    rt = _rt(4, attn_impl=impl)
    x = tm._embed_tokens(rt, cfg, m["port"][4], torch.from_numpy(
        np.asarray(token))[:, None], _gen())[:, 0]
    pos_t = torch.tensor(PROMPT, dtype=torch.int32)
    xpos_t = torch.tensor(29, dtype=torch.int32)
    for i, kind, p in tm._blocks(cfg, m["port"][4]):
        x, _ = tm._block_decode(rt, cfg, kind, p, x, tm._layer(cache, i),
                                PROMPT, pos_t, CACHE, xpos_t)
    got = tm.rms_norm(x, m["port"][4]["final_norm"])
    _assert_rel(got, want, HIDDEN_REL)


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(models, arch, q):
    """The port's own consistency: after a prefill of the PROMPT-position
    prompt, teacher-forced decode steps give the full forward's greedy
    tokens over the prompt and the teacher tokens (the same frames or
    patches) in at least 95% of the positions: the prefill's caches
    (whisper's cross cache included) reach the decode steps."""
    m = models(arch)
    cfg, params, rt = m["cfg"], m["port"][q], _rt(q)
    tb = make_batch(cfg, ShapeConfig("t", PROMPT, 2, "prefill"), rt, seed=2,
                    device="cpu")
    n = 12
    teacher = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, n)))
    tok, kv = tm.prefill(rt, cfg, params, tb, _gen())
    cache = tm.init_cache(rt, cfg, 2, PROMPT + n, device="cpu")
    for k, v in kv.items():
        cache[k][:, :, :v.shape[2]].copy_(v)
    dec = [tok]
    for t in range(n - 1):
        nt, cache = tm.decode_step(rt, cfg, params,
                                   {"token": teacher[:, t],
                                    "pos": PROMPT + t, "cache": cache},
                                   _gen(t + 1))
        dec.append(nt)
    full = dict(tb, tokens=torch.cat([tb["tokens"], teacher[:, :n - 1]], 1))
    x, enc_out, _ = tm._prepare_inputs(rt, cfg, params, full, _gen())
    h = tm._backbone(rt, cfg, params, x, enc_out=enc_out)[:, PROMPT - 1:]
    fwd = torch.stack([vocab_parallel_greedy(rt, params["embed"], h[:, t])
                       for t in range(n)], 1)
    assert (fwd == torch.stack(dec, 1)).float().mean() >= 0.95


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_impls_agree(models, arch):
    """``"kernel"`` (the kernels' plain versions here: non-causal flash
    attention over Sq ≠ Skv for the cross attention, the read-only
    decode over the cross cache) and ``"reference"`` give the same
    prefill and decode steps."""
    m = models(arch)
    cfg, params = m["cfg"], m["port"][4]
    tb = make_batch(cfg, ShapeConfig("t", PROMPT, 2, "prefill"), _rt(4),
                    seed=4, device="cpu")
    outs = []
    for impl in ("kernel", "reference"):
        rt = _rt(4, attn_impl=impl, attn_chunk=8)
        tok, kv = tm.prefill(rt, cfg, params, tb, _gen())
        cache = tm.init_cache(rt, cfg, 2, CACHE, device="cpu")
        for k, v in kv.items():
            cache[k][:, :, :v.shape[2]].copy_(v)
        toks = [tok]
        for t in range(STEPS):
            tok, cache = tm.decode_step(rt, cfg, params,
                                        {"token": tok, "pos": PROMPT + t,
                                         "cache": cache}, _gen(t))
            toks.append(tok)
        outs.append((torch.stack(toks), cache))
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    for k in outs[0][1]:
        _assert_rel(outs[0][1][k], outs[1][1][k], HIDDEN_REL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax_loop(jx, models, arch, q):
    """``serve(device="cpu")`` against the reference's prefill + decode
    loop (``repro/launch/serve.py``, the cross cache re-homed into the
    decode cache) on serve's own parameters and inputs."""
    jax, jnp = jx["jax"], jx["jnp"]
    m = models(arch)
    n_gen = 4
    res = serve(arch, batch=2, prompt_len=PROMPT, gen_tokens=n_gen,
                model_parallel=q, seed=3, device="cpu")
    assert res.tokens.shape == (2, n_gen) and res.tokens.dtype == np.int64
    assert len(res.step_seconds) == n_gen - 1
    params = tm.init_params(m["cfg"], 3, device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    _, jb = _batch(jx, m, b=2, seed=3)
    fn, key = m["fn"], jax.random.PRNGKey(3)
    tok, kv = fn["prefill"](jp, jb, key)
    logits = [_jax_logits(jx, jp["embed"], fn["hidden"](jp, jb, key)[:, -1])]
    want = [np.asarray(tok)]
    cache = jx["jm"].init_cache(jx["rt"], m["jcfg"], 2, PROMPT + n_gen)
    cache = {k: jax.lax.dynamic_update_slice_in_dim(cache[k], kv[k], 0,
                                                    axis=2) for k in cache}
    for i in range(n_gen - 1):
        key = jax.random.PRNGKey(i)
        pos = jnp.asarray(PROMPT + i, jnp.int32)
        hj = fn["decode_hidden"](jp, tok, cache, pos, key)
        tok, cache = fn["decode"](jp, {"token": tok, "pos": pos,
                                       "cache": cache}, key)
        logits.append(_jax_logits(jx, jp["embed"], hj))
        want.append(np.asarray(tok))
    _assert_tokens(res.tokens.T, np.stack(want), np.stack(logits))
    assert set(res.cache) == set(cache)
    for k in cache:
        _assert_rel(res.cache[k], cache[k], HIDDEN_REL)


def test_serve_vlm_prompt_counts_the_patches():
    with pytest.raises(ValueError, match="patches"):
        serve("pixtral_12b", prompt_len=8, device="cpu")
    res = serve("pixtral_12b", batch=1, prompt_len=9, gen_tokens=2,
                model_parallel=2, device="cpu")
    assert res.cache["k"].shape[2] == 12        # 9 + 2 rounded up to 2 | ·


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(jx, models, arch, q, monkeypatch):
    """``train_loss`` (pixtral's patch prefix dropped before the head) and
    every leaf's gradient through autograd, ``enc_proj`` and
    ``patch_proj`` included, with f32 activations in both packages and
    the plain projections, against ``jax.value_and_grad``."""
    m = models(arch)
    _, jb = _batch(jx, m, "train", s=PROMPT, b=2, seed=6)
    want_loss, want = m["fn"]["grad_f32"](m["jax"], jb)
    want = _keystr(jx, want)
    monkeypatch.setattr(tm, "ACT_DTYPE", torch.float32)
    batch = {k: torch.from_numpy(_f32(v)) if k in ("frames", "patches")
             else torch.as_tensor(np.asarray(v), dtype=torch.int64)
             for k, v in jb.items()}
    batch = {k: v.to(torch.bfloat16) if k in ("frames", "patches") else v
             for k, v in batch.items()}
    rt = _rt(q, secure_embed=False, scan_impl="reference",
             attn_impl="reference")
    loss, grads = ttrain.loss_and_grads(rt, m["cfg"], m["port"][q], batch,
                                        _gen(q))
    assert abs(float(loss) - float(want_loss)) <= 1e-5
    got = dict(leaves_with_path(grads))
    assert list(got) == list(want)
    assert FRONTEND[arch][0] in "".join(got)
    for path, g in got.items():
        w = want[path]
        assert torch.isfinite(g).all() and g.abs().max() > 0, path
        _assert_rel(g, w, F32_GRAD_REL)
        assert np.linalg.norm(g.numpy() - w) \
            <= 2 * F32_GRAD_L2 * np.linalg.norm(w), path


@pytest.mark.parametrize("arch", ARCHS)
def test_train_runs_and_lowers_the_loss(arch):
    """``launch.train.train`` on the reduced config at q = 2 (zero frames
    or patches beside the tokens, as the reference's loop gives):
    finite losses, AdamW's falling."""
    losses = ttrain.train(arch, 8, 2, 16, 3e-3, log_every=100,
                          model_parallel=2, device="cpu")
    assert np.isfinite(losses).all()
    assert losses[0] - np.mean(losses[-3:]) > 0.05


# ---------------------------------------------------------------------------
# q = 4 against the reference on 4 devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _jax_q4_run(tmp_path_factory):
    """The reference on 4 forced host devices for both architectures,
    from its own ``init_params`` and ``make_batch`` (the same values as
    ``models``'): ``secure_feature_project`` with its masks off, the
    prefill's token, normed hidden state and caches, and three
    teacher-forced decode steps from the prefilled cache (their tokens,
    normed hidden states and the final cache).  It starts with the
    module's first test and runs beside the others; ``jax_q4`` waits for
    it."""
    if importlib.util.find_spec("jax") is None:   # a card's machine
        yield None
        return
    tmp = tmp_path_factory.mktemp("frontends_q4")
    script = textwrap.dedent(f"""
        import dataclasses
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs.base import ShapeConfig, get_arch
        from repro.configs.inputs import make_batch
        from repro.launch.mesh import make_mesh_for
        from repro.models import model as jm
        from repro.sharding.api import Runtime, use_runtime
        from repro.vfl.embed import secure_feature_project
        rt = Runtime(mesh=make_mesh_for(4, 4), batch_axes=("data",),
                     attn_chunk=32, loss_chunk=16)
        out = {{}}
        for arch, proj, feat in (("whisper_tiny", "enc_proj", "frames"),
                                 ("pixtral_12b", "patch_proj", "patches")):
            cfg = get_arch(arch).reduced()
            kind = "attn_cross" if cfg.enc_dec else "attn_mlp"
            p = jm.init_params(cfg, jax.random.PRNGKey(0))

            def decode_hidden(p, token, cache, pos, key):
                x = jm._embed_tokens(rt, cfg, p, token[:, None], key)[:, 0]
                for i in range(cfg.n_layers):
                    x, _, _ = jm._block_decode(
                        rt, cfg, kind, jax.tree.map(lambda a: a[i],
                                                    p["stack"]), x,
                        jax.tree.map(lambda a: a[i], cache), pos, None)
                return jm.rms_norm(x, p["final_norm"])

            def hidden(p, b, key):
                x, enc_out, _ = jm._prepare_inputs(rt, cfg, p, b, key)
                return jm._backbone(rt, cfg, p, x, x.shape[1],
                                    enc_out=enc_out)[0][:, -1]

            with use_runtime(rt):
                jb = make_batch(cfg, ShapeConfig("t", {PROMPT}, {B},
                                                 "prefill"), rt, seed=0)
                off = dataclasses.replace(rt, mask_scale=0.0)
                out[arch + "_project"] = np.asarray(jax.jit(
                    lambda w, f: secure_feature_project(
                        off, w, f, jax.random.PRNGKey(1)))(
                    p[proj], jb[feat]).astype(jnp.float32))
                key = jax.random.PRNGKey(0)
                tok, kv = jax.jit(lambda p, b: jm.prefill(
                    rt, cfg, p, b, key))(p, jb)
                out[arch + "_tok"] = np.asarray(tok)
                out[arch + "_h"] = np.asarray(jax.jit(hidden)(
                    p, jb, key).astype(jnp.float32))
                cache = jm.init_cache(rt, cfg, {B}, {CACHE})
                cache = {{k: jax.lax.dynamic_update_slice_in_dim(
                    cache[k], kv[k], 0, axis=2) for k in cache}}
                for k, v in cache.items():
                    out[f"{{arch}}_cache0_{{k}}"] = np.asarray(
                        v.astype(jnp.float32))
                teacher = np.random.default_rng(1).integers(
                    0, cfg.vocab, ({B}, {STEPS}))
                dec = jax.jit(lambda p, b, k: jm.decode_step(
                    rt, cfg, p, b, k))
                hid = jax.jit(decode_hidden)
                for t in range({STEPS}):
                    k = jax.random.PRNGKey(t)
                    token = jnp.asarray(teacher[:, t], jnp.int32)
                    pos = jnp.asarray({PROMPT} + t, jnp.int32)
                    out[f"{{arch}}_dh{{t}}"] = np.asarray(hid(
                        p, token, cache, pos, k).astype(jnp.float32))
                    nt, cache = dec(p, {{"token": token, "pos": pos,
                                         "cache": cache}}, k)
                    out[f"{{arch}}_dtok{{t}}"] = np.asarray(nt)
                for k, v in cache.items():
                    out[f"{{arch}}_cache{STEPS}_{{k}}"] = np.asarray(
                        v.astype(jnp.float32))
        np.savez({str(tmp / "out.npz")!r}, **out)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"))
    with open(tmp / "stderr.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                                stdout=subprocess.DEVNULL, stderr=err)
    try:
        yield proc, tmp
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def jax_q4(_jax_q4_run):
    proc, tmp = _jax_q4_run
    rc = proc.wait(timeout=600)
    assert rc == 0, (tmp / "stderr.txt").read_text()[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("arch", ARCHS)
def test_q4_matches_jax_on_4_devices(jx, models, jax_q4, arch):
    """The port at q = 4 against the reference's 4-device run: the
    unmasked projection over the same 4 feature blocks (one bf16 ulp
    elementwise), the prefill's token and caches, and three decode steps
    (whisper's cross cache 4 shards of 8, read at enc_seq − 1), each from
    the reference's cache: their tokens and the final cache."""
    m = models(arch)
    ref = {k[len(arch) + 1:]: v for k, v in jax_q4.items()
           if k.startswith(arch)}
    proj, feat = FRONTEND[arch]
    tb, _ = _batch(jx, m)
    got = secure_feature_project(_rt(4, mask_scale=0.0), m["port"][4][proj],
                                 tb[feat], _gen())
    np.testing.assert_allclose(got.float().numpy(), ref["project"],
                               rtol=ULP, atol=0)
    tok, kv = tm.prefill(_rt(4), m["cfg"], m["port"][4], tb, _gen())
    _assert_tokens(tok.numpy(), ref["tok"],
                   _jax_logits(jx, m["jax"]["embed"], ref["h"]))
    for k, v in kv.items():
        _assert_rel(v, ref[f"cache0_{k}"][:, :, :v.shape[2]], HIDDEN_REL)
    teacher = _teacher(m)
    dec, want, logits = [], [], []
    cache = {k[len("cache0_"):]: torch.from_numpy(v).to(torch.bfloat16)
             for k, v in ref.items() if k.startswith("cache0_")}
    for t in range(STEPS):
        nt, cache = tm.decode_step(_rt(4), m["cfg"], m["port"][4],
                                   {"token": torch.from_numpy(teacher[:, t]),
                                    "pos": PROMPT + t, "cache": cache},
                                   _gen(t))
        dec.append(nt.numpy())
        want.append(ref[f"dtok{t}"])
        logits.append(_jax_logits(jx, m["jax"]["embed"], ref[f"dh{t}"]))
    _assert_tokens(np.stack(dec), np.stack(want), np.stack(logits))
    for k, v in cache.items():
        _assert_rel(v, ref[f"cache{STEPS}_{k}"], HIDDEN_REL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_kernel_routes_match_plain(cuda_device, arch):
    """The reduced model at q = 4 on the card: a prefill launches
    ``flash_attention`` once per attention (whisper: 2 encoder + 2
    decoder self + 2 cross, non-causal over Sq ≠ Skv; pixtral: 2 over
    the patch prefix and the text) and a decode step ``decode_attention``
    once per attention (whisper: self and the read-only cross per
    layer), nothing else; each mixer on the kernel route within
    ``HIDDEN_REL`` of the plain route on the same input and cache."""
    cfg = get_arch(arch).reduced()
    params = tm.init_params(cfg, 0, device=cuda_device)
    rt, plain = _rt(4), _rt(4, attn_impl="reference")
    batch = make_batch(cfg, ShapeConfig("t", 64, 2, "prefill"), rt,
                       device=cuda_device)
    n = cfg.n_layers
    flash = 3 * n if cfg.enc_dec else n
    with torch.no_grad():
        for lib in (fa.KERNEL, da.KERNEL, ss.KERNEL, vg.KERNEL):
            lib.reset_launches()
        tok, kv = tm.prefill(rt, cfg, params, batch,
                             mask_generator(0, device=cuda_device))
        torch.cuda.synchronize()
        assert fa.KERNEL.launches == {"flash_attention": flash}
        cache = tm.init_cache(rt, cfg, 2, 68, device=cuda_device)
        for k, v in kv.items():
            cache[k][:, :, :v.shape[2]].copy_(v)
        ref_cache = {k: v.clone() for k, v in cache.items()}
        tm.decode_step(rt, cfg, params, {"token": tok, "pos": 64,
                                         "cache": cache},
                       mask_generator(1, device=cuda_device))
        torch.cuda.synchronize()
        assert da.KERNEL.launches == {
            "decode_attention": 2 * n if cfg.enc_dec else n}
        assert fa.KERNEL.launches == {"flash_attention": flash}
        assert not any(ss.KERNEL.launches.values())
        assert not any(vg.KERNEL.launches.values())
        tm.decode_step(plain, cfg, params, {"token": tok, "pos": 64,
                                            "cache": ref_cache},
                       mask_generator(1, device=cuda_device))
        for k in cache:
            _assert_rel(cache[k].cpu(), ref_cache[k].cpu(), HIDDEN_REL)
        x, enc_out, _ = tm._prepare_inputs(
            rt, cfg, params, batch, mask_generator(2, device=cuda_device))
        for i, kind, p in tm._blocks(cfg, params):
            h = tm.rms_norm(x, p["norm1"])
            outs = [tm._apply_attention(r, cfg, p["attn"], h, None)[0]
                    for r in (rt, plain)]
            _assert_rel(outs[0].cpu(), outs[1].cpu(), HIDDEN_REL)
            if "xattn" in p:
                outs = [tm._apply_attention(r, cfg, p["xattn"], h, None,
                                            causal=False, kv_src=enc_out)[0]
                        for r in (rt, plain)]
                _assert_rel(outs[0].cpu(), outs[1].cpu(), HIDDEN_REL)
            x, _ = tm._block_fwd(rt, cfg, kind, p, x, None, enc_out=enc_out)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_serve_runs(cuda_device, arch):
    res = serve(arch, batch=2, prompt_len=32, gen_tokens=4,
                model_parallel=4, seed=0, device=cuda_device)
    cfg = get_arch(arch).reduced()
    assert res.tokens.shape == (2, 4)
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    assert all(torch.isfinite(v.float()).all() for v in res.cache.values())
    again = serve(arch, batch=2, prompt_len=32, gen_tokens=4,
                  model_parallel=4, seed=0, device=cuda_device)
    np.testing.assert_array_equal(again.tokens, res.tokens)
