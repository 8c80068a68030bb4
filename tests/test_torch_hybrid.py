"""The port's hybrid period stack (the reduced jamba-v0.1-52b: one period
of (ssm_mlp, ssm_moe, attn_mlp, ssm_moe), d_model 128, 4 heads over 2,
4 experts top-2 of width 64, N = 8, vocabulary 512) against the JAX
package, at 4 layers (one period, n_per = 1) and 8 (n_per = 2: only
there does a position-major loop give another order than the
reference's period-major one).

Parameters come from the reference's ``init_params`` and cross as numpy
arrays through ``convert.lm_params``; tokens come from both packages'
``make_batch`` with one seed.  The reference runs on one device (its
party count 1) and, for ``train_loss``, the prefill and three decode
steps at q = 4 under both dispatch modes, in one subprocess with 4
forced host devices.  As in the reference, a period stack's prefill
returns no cache and decoding starts from zeros (ROADMAP C.R6).

Tolerances, those of ``tests/test_torch_lm.py`` and
``tests/test_torch_moe.py``, with their reasons:

* hidden states and caches (KV, conv, h) within ``HIDDEN_REL`` = 2e-2 of
  the largest reference value (two bf16 ulps and a little over: the
  frameworks round bf16 products and sums at different places);
* tokens equal wherever the reference's top-two logit margin exceeds
  2⁻⁵ of its largest logit (below it a tie may break either way);
* the loss (with the MoE layers' weighted lb_loss and z_loss) within
  ``LOSS_TOL`` = 2e-3;
* every leaf's gradient, with f32 activations in both packages (only the
  head rounds to bf16), within ``F32_GRAD_REL`` = 2e-3 of the leaf's
  largest reference value and ``F32_GRAD_L2`` = 2e-4 in relative L2 (at
  bf16 an expert's gradient moves some 7% under one bf16 ulp of its
  input, ``tests/test_torch_moe.py``);
* the router's selections: ``tests/test_torch_moe.py`` holds them equal
  wherever the k-th to (k+1)-th probability margin exceeds
  ``ROUTE_MARGIN`` = 1e-6 (below it a 1-ulp logit difference may swap
  them); here the MoE layers are held through the hidden states,
  caches, tokens and gradients above.

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
from test_torch_lm import HIDDEN_REL, _assert_rel, _assert_tokens, _jax_logits
from test_torch_moe import F32_GRAD_L2, F32_GRAD_REL, LOSS_TOL

from repro_torch import convert
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.configs.inputs import make_batch
from repro_torch.core.secure_agg import mask_generator
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels import vfl_grad as vg
from repro_torch.launch import train as ttrain
from repro_torch.launch.serve import serve
from repro_torch.models import model as tm
from repro_torch.optim.delayed import leaf_delays
from repro_torch.optim.tree import leaves_with_path
from repro_torch.sharding.api import Runtime

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH = "jamba_v0_1_52b"
LAYERS = [4, 8]                        # n_per = 1 and 2
QS = [1, 4]
B, S = 2, 32                           # train_loss's batch
STEPS = 16                             # teacher-forced decode positions
CACHE = 20                             # decode cache positions (serve's too)


def _rt(q, **kw):
    return Runtime(model_size=q, **kw)


def _gen(seed=0):
    return mask_generator(seed, device="cpu")


def _cfg(layers):
    return dataclasses.replace(get_arch(ARCH).reduced(), n_layers=layers)


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
    return dict(jax=jax, jnp=jnp, jm=jm, inputs=jinputs, Shape=JShape,
                get_arch=jget_arch,
                rt=single_device_runtime(attn_chunk=32, loss_chunk=16))


def _jfns(jx, cfg):
    """The reference's jitted ``prefill`` and ``decode_step``, the normed
    hidden states behind their tokens, and ``train_loss``'s value and
    gradient at bf16 and f32 activations."""
    jax, jm, rt = jx["jax"], jx["jm"], jx["rt"]
    n_per = cfg.n_layers // len(cfg.period)

    def layer(tree, i):
        return jax.tree.map(lambda a: a[i], tree)

    def decode_hidden(p, token, cache, pos, key):
        x = jm._embed_tokens(rt, cfg, p, token[:, None], key)[:, 0]
        for i in range(n_per):
            for j, kind in enumerate(cfg.period):
                x, _, _ = jm._block_decode(rt, cfg, kind,
                                           layer(p["periods"][j], i), x,
                                           layer(cache[j], i), pos, None)
        return jm.rms_norm(x, p["final_norm"])

    def last_hidden(p, tokens, key):
        x = jm._embed_tokens(rt, cfg, p, tokens, key)
        return jm._backbone(rt, cfg, p, x, x.shape[1])[0][:, -1]

    def grad_f32(p, batch):
        # f32 activations and the plain embedding (no mask residue)
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
        last_hidden=jax.jit(last_hidden),
        decode_hidden=jax.jit(decode_hidden),
        grad_f32=grad_f32)


@pytest.fixture(scope="module")
def models(jx):
    """layers → the config (port and reference), the reference's
    parameters (numpy and JAX), the port's at each q, a "train" batch and
    the reference's jitted functions; built at first use."""
    built = {}

    def get(layers):
        if layers not in built:
            jax = jx["jax"]
            cfg = _cfg(layers)
            jcfg = dataclasses.replace(jx["get_arch"](ARCH).reduced(),
                                       n_layers=layers)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            params = jax.tree.map(np.asarray, jx["jm"].init_params(
                jcfg, jax.random.PRNGKey(0)))
            batch = jx["inputs"].make_batch(
                jcfg, jx["Shape"]("t", S, B, "train"), jx["rt"], seed=3)
            built[layers] = dict(
                cfg=cfg, jcfg=jcfg, np=params,
                jax=jax.tree.map(jx["jnp"].asarray, params),
                port={q: convert.lm_params(params, q=q, device="cpu")
                      for q in QS},
                batch={k: np.asarray(v) for k, v in batch.items()},
                fn=_jfns(jx, jcfg))
        return built[layers]
    return get


def _keystr(jx, tree):
    jax = jx["jax"]
    return {jax.tree_util.keystr(kp): v for kp, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# configuration, parameters, cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", LAYERS)
def test_config_and_layer_kinds_match_jax(jx, layers):
    """The full and reduced configs equal the reference's, and
    ``layer_kinds`` is its period repeated n_per times."""
    full, jfull = get_arch(ARCH), jx["get_arch"](ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert tm.layer_kinds(full) == jx["jm"].layer_kinds(jfull)
    assert tm.layer_kinds(full).count("attn_mlp") == 4
    cfg = _cfg(layers)
    jcfg = dataclasses.replace(jx["get_arch"](ARCH).reduced(),
                               n_layers=layers)
    assert tm.layer_kinds(cfg) == jx["jm"].layer_kinds(jcfg) \
        == ("ssm_mlp", "ssm_moe", "attn_mlp", "ssm_moe") * (layers // 4)


def test_a_partial_period_raises():
    cfg = _cfg(6)
    with pytest.raises(ValueError, match="periods"):
        tm.layer_kinds(cfg)
    with pytest.raises(ValueError, match="periods"):
        serve(ARCH, n_layers=6, device="cpu")


@pytest.mark.parametrize("layers", LAYERS)
def test_init_params_tree_matches_jax(jx, models, layers):
    """The port's ``init_params`` draws the reference's period tree
    (``periods``: a list of one stacked tree per position; names, shapes,
    dtypes, ``keystr`` paths) and ``lm_params`` carries the reference's
    across bit for bit."""
    m = models(layers)
    mine = tm.init_params(m["cfg"], 0, device="cpu")
    assert isinstance(mine["periods"], list) and len(mine["periods"]) == 4
    got = dict(leaves_with_path(mine))
    carried = dict(leaves_with_path(m["port"][1]))
    want = _keystr(jx, m["np"])
    assert list(got) == list(carried) == list(want)
    assert "['periods'][1]['moe']['w_up']" in want
    assert "['periods'][2]['attn']['wq']" in want
    assert "['periods'][0]['ssm']['a_log']" in want
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape
        assert w.shape[0] == layers // 4 or not path.startswith(
            "['periods']")
        assert got[path].dtype == carried[path].dtype == torch.float32
        np.testing.assert_array_equal(carried[path].numpy(), w)


@pytest.mark.parametrize("layers", LAYERS)
def test_init_cache_matches_jax(jx, models, layers):
    """``init_cache`` is the reference's list of per-position entries:
    {"k", "v"} (n_per, B, S, Hkv, dh) bf16 at the attention position,
    {"conv"} (n_per, B, K−1, Ci) bf16 and {"h"} (n_per, B, Ci, N) f32 at
    the SSM positions; ``make_batch``'s decode mode carries it."""
    m = models(layers)
    cache = tm.init_cache(_rt(2), m["cfg"], 3, 10, device="cpu")
    jcache = jx["jm"].init_cache(jx["rt"], m["jcfg"], 3, 10)
    assert isinstance(cache, list) and len(cache) == len(jcache) == 4
    for got, want in zip(cache, jcache):
        assert set(got) == set(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[1] == str(want[k].dtype)
            assert not got[k].any()
    assert set(cache[2]) == {"k", "v"} and set(cache[0]) == {"conv", "h"}
    batch = make_batch(m["cfg"], ShapeConfig("d", 10, 3, "decode"), _rt(2),
                       device="cpu")
    assert isinstance(batch["cache"], list) and batch["pos"] == 5


@pytest.mark.parametrize("layers", LAYERS)
def test_leaf_delays_match_jax(models, layers):
    """The delayed optimiser's md5 delays over the period tree's
    ``keystr`` paths are the reference's on every leaf."""
    import jax
    from repro.optim.delayed import _leaf_delay as jdelay
    m = models(layers)
    paths = [jax.tree_util.keystr(kp) for kp, _ in
             jax.tree_util.tree_flatten_with_path(m["np"])[0]]
    for tau in (3, 4):
        got = leaf_delays(m["port"][1], tau)
        assert list(got) == paths
        assert got == {path: jdelay(path, tau) for path in paths}


def test_checkpoint_of_a_period_tree_crosses_packages(jx, models, tmp_path):
    """A bundle of the period tree saved by either package loads in the
    other, every leaf bit for bit."""
    from repro.checkpoint import load_checkpoint as jload
    from repro.checkpoint import save_checkpoint as jsave
    m = models(8)
    save_checkpoint(str(tmp_path / "port"), {"params": m["port"][1]},
                    step=2)
    like = {"params": jx["jax"].tree.map(np.zeros_like, m["np"])}
    got = _keystr(jx, jload(str(tmp_path / "port"), like))
    jsave(str(tmp_path / "ref"), {"params": m["jax"]}, step=3)
    mine = load_checkpoint(str(tmp_path / "ref"),
                           {"params": tm.init_params(m["cfg"], 1,
                                                     device="cpu")})
    assert isinstance(mine["params"]["periods"], list)
    mine = dict(leaves_with_path(mine))
    want = _keystr(jx, {"params": m["np"]})
    assert list(got) == list(mine) == list(want)
    for path, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), w)
        np.testing.assert_array_equal(np.asarray(mine[path]), w)


def test_lm_params_takes_period_trees_only_whole(models):
    tree = dict(models(4)["np"])
    tree["periods"] = list(tree["periods"])
    tree["periods"][1] = {"norm1": 0, "ssm": {}}
    with pytest.raises(ValueError, match="not an LM parameter tree"):
        convert.lm_params(tree, q=1, device="cpu")
    with pytest.raises(ValueError):
        convert.lm_params(models(4)["np"], q=3, device="cpu")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompt(jx, m, b=4, s=16, seed=0):
    shape = ShapeConfig("t", s, b, "prefill")
    got = make_batch(m["cfg"], shape, _rt(1), seed=seed, device="cpu")
    want = jx["inputs"].make_batch(m["jcfg"], shape, jx["rt"], seed=seed)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    return got, want


@pytest.mark.parametrize("secure", [False, True])
@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("layers", LAYERS)
def test_prefill_matches_jax(jx, models, layers, q, secure):
    """The next tokens wherever the reference's margin decides them, and
    no cache from either package (C.R6)."""
    m = models(layers)
    key = jx["jax"].random.PRNGKey(0)
    tb, jb = _prompt(jx, m)
    want, jcache = m["fn"]["prefill"](m["jax"], jb, key)
    got, cache = tm.prefill(_rt(q, secure_embed=secure), m["cfg"],
                            m["port"][q], tb, _gen())
    assert cache is None and jcache is None
    h = m["fn"]["last_hidden"](m["jax"], jb["tokens"], key)
    _assert_tokens(got.numpy(), np.asarray(want),
                   _jax_logits(jx, m["jax"]["embed"], h))


def _cache_t(jcache, jnp, like):
    return [{k: torch.from_numpy(np.array(v.astype(jnp.float32)))
             .to(like[j][k].dtype) for k, v in c.items()}
            for j, c in enumerate(jcache)]


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("layers", LAYERS)
def test_decode_steps_match_jax(jx, models, layers, q):
    """Sixteen teacher-forced decode steps from ``init_cache``'s zeros
    (the state serving starts from, C.R6), token by token: each step
    starts from the reference's cache, and the new cache (KV written in
    place, the SSM states re-stacked per position) and the tokens must
    match."""
    jax, jnp = jx["jax"], jx["jnp"]
    m = models(layers)
    _, jb = _prompt(jx, m, s=STEPS)
    jcache = jx["jm"].init_cache(jx["rt"], m["jcfg"], 4, CACHE)
    like = tm.init_cache(_rt(q), m["cfg"], 4, CACHE, device="cpu")
    logits, want_tok, got_tok = [], [], []
    for t in range(STEPS):
        token, key = jb["tokens"][:, t], jax.random.PRNGKey(t)
        pos = jnp.asarray(t, jnp.int32)
        want, jnext = m["fn"]["decode"](
            m["jax"], {"token": token, "pos": pos, "cache": jcache}, key)
        cache = _cache_t(jcache, jnp, like)
        got, nxt = tm.decode_step(_rt(q), m["cfg"], m["port"][q],
                                  {"token": torch.from_numpy(
                                      np.asarray(token)).long(),
                                   "pos": t, "cache": cache}, _gen(t))
        assert isinstance(nxt, list) and nxt[2] is cache[2]
        for j, entry in enumerate(nxt):
            for k, v in entry.items():
                assert v.dtype == like[j][k].dtype
                assert tuple(v.shape) == jnext[j][k].shape
                _assert_rel(v, jnext[j][k], HIDDEN_REL)
        hj = m["fn"]["decode_hidden"](m["jax"], token, jcache, pos, key)
        logits.append(_jax_logits(jx, m["jax"]["embed"], hj))
        want_tok.append(np.asarray(want))
        got_tok.append(got.numpy())
        jcache = jnext
    _assert_tokens(np.stack(got_tok), np.stack(want_tok), np.stack(logits))


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("layers", LAYERS)
def test_serve_matches_jax_loop(jx, models, layers, q):
    """``serve(device="cpu")`` against the reference's prefill +
    decode_step loop (``repro/launch/serve.py``: no cache re-homed for a
    period stack, decode from zeros) on serve's own parameters and
    prompt; the final caches within the hidden tolerance."""
    jax, jnp = jx["jax"], jx["jnp"]
    m = models(layers)
    b, s, n_gen = 4, 16, CACHE - 16   # the prefill's and decode's shapes
    res = serve(ARCH, batch=b, prompt_len=s, gen_tokens=n_gen,
                model_parallel=q, seed=3, device="cpu", n_layers=layers)
    assert res.tokens.shape == (b, n_gen) and res.tokens.dtype == np.int64
    assert len(res.step_seconds) == n_gen - 1
    params = tm.init_params(m["cfg"], 3, device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jb = jx["inputs"].make_batch(m["jcfg"], ShapeConfig("serve", s, b,
                                                        "prefill"),
                                 jx["rt"], 3)
    key = jax.random.PRNGKey(3)
    tok, kv = m["fn"]["prefill"](jp, jb, key)
    assert kv is None
    logits = [_jax_logits(jx, jp["embed"],
                          m["fn"]["last_hidden"](jp, jb["tokens"], key))]
    want = [np.asarray(tok)]
    max_len = -(-(s + n_gen) // q) * q
    cache = jx["jm"].init_cache(jx["rt"], m["jcfg"], b, max_len)
    for i in range(n_gen - 1):
        key = jax.random.PRNGKey(i)
        pos = jnp.asarray(s + i, jnp.int32)
        hj = m["fn"]["decode_hidden"](jp, tok, cache, pos, key)
        tok, cache = m["fn"]["decode"](
            jp, {"token": tok, "pos": pos, "cache": cache}, key)
        logits.append(_jax_logits(jx, jp["embed"], hj))
        want.append(np.asarray(tok))
    _assert_tokens(res.tokens.T, np.stack(want), np.stack(logits))
    assert isinstance(res.cache, list)
    for got, jc in zip(res.cache, cache):
        for k in got:
            assert torch.isfinite(got[k].float()).all()
            _assert_rel(got[k], jc[k], HIDDEN_REL)
    np.testing.assert_array_equal(
        serve(ARCH, batch=b, prompt_len=s, gen_tokens=n_gen,
              model_parallel=q, seed=3, device="cpu",
              n_layers=layers).tokens, res.tokens)


def test_decode_matches_forward(models):
    """The port's own consistency (``tests/test_decode_consistency.py``'s
    check, jamba included there): greedy tokens of the full forward at
    every position against teacher-forced decode from the zero state, in
    at least 95% of the positions (cf = E/k, so that the forward's
    capacity drops nothing that a decode step would keep)."""
    m = models(8)
    cfg = dataclasses.replace(m["cfg"], moe=dataclasses.replace(
        m["cfg"].moe, capacity_factor=m["cfg"].moe.n_experts
        / m["cfg"].moe.top_k))
    params, rt = m["port"][4], _rt(4)
    b, s = 2, 16
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s)))
    x = tm._embed_tokens(rt, cfg, params, tokens, _gen())
    h = tm._backbone(rt, cfg, params, x)
    from repro_torch.vfl.heads import vocab_parallel_greedy
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
# training
# ---------------------------------------------------------------------------

def _train_rt(q, **kw):
    return _rt(q, attn_chunk=32, loss_chunk=16, scan_impl="reference",
               attn_impl="reference", **kw)


def _tbatch(m):
    return {k: torch.as_tensor(np.array(v), dtype=torch.int64)
            for k, v in m["batch"].items()}


@pytest.fixture(scope="module")
def jgrads(jx, models):
    """layers → the reference's f32 (loss, {key path: gradient})."""
    cache = {}

    def get(layers):
        if layers not in cache:
            m = models(layers)
            batch = {k: jx["jnp"].asarray(v) for k, v in m["batch"].items()}
            loss, g = m["fn"]["grad_f32"](m["jax"], batch)
            cache[layers] = (float(loss), _keystr(jx, g))
        return cache[layers]
    return get


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("layers", LAYERS)
def test_train_loss_and_grads_match_jax(models, jgrads, layers, q,
                                        monkeypatch):
    """``train_loss`` (the MoE layers' aux terms summed over all 2·n_per
    of them) and every leaf's gradient through autograd, with f32
    activations in both packages and the plain embedding (no mask
    residue), against ``jax.value_and_grad``; the bf16 loss through the
    secure embedding is held at q = 4 (``test_q4_matches_jax_on_4_devices``)."""
    m = models(layers)
    want_loss, want = jgrads(layers)
    monkeypatch.setattr(tm, "ACT_DTYPE", torch.float32)
    loss, grads = ttrain.loss_and_grads(_train_rt(q, secure_embed=False),
                                        m["cfg"], m["port"][q], _tbatch(m),
                                        _gen(q))
    assert abs(float(loss) - want_loss) <= 1e-5
    got = dict(leaves_with_path(grads))
    assert list(got) == list(want)
    for path, g in got.items():
        w = want[path]
        assert torch.isfinite(g).all() and g.abs().max() > 0, path
        _assert_rel(g, w, F32_GRAD_REL)
        assert np.linalg.norm(g.numpy() - w) \
            <= F32_GRAD_L2 * np.linalg.norm(w), path


def test_train_loss_sums_every_moe_layers_aux(models, monkeypatch):
    """``train_loss`` adds AUX_LOSS_WEIGHT·Σ lb_loss + Z_LOSS_WEIGHT·Σ
    z_loss over the 2·n_per MoE layers of the period stack."""
    m = models(8)
    rt, batch = _train_rt(4), _tbatch(m)
    seen = []
    apply = tm.moe_lib.apply_moe_sharded

    def spy(*a, **kw):
        out, aux = apply(*a, **kw)
        seen.append({k: float(v) for k, v in aux.items()})
        return out, aux

    with torch.no_grad():
        base = float(tm.train_loss(rt, m["cfg"], m["port"][4], batch,
                                   _gen()))
        monkeypatch.setattr(tm, "AUX_LOSS_WEIGHT", 0.0)
        monkeypatch.setattr(tm, "Z_LOSS_WEIGHT", 0.0)
        monkeypatch.setattr(tm.moe_lib, "apply_moe_sharded", spy)
        bare = float(tm.train_loss(rt, m["cfg"], m["port"][4], batch,
                                   _gen()))
    assert len(seen) == 4
    assert all(a["lb_loss"] > 0 and a["z_loss"] > 0 for a in seen)
    extra = 0.01 * sum(a["lb_loss"] for a in seen) \
        + 1e-3 * sum(a["z_loss"] for a in seen)
    assert abs(base - bare - extra) <= 1e-5


def test_train_runs_and_lowers_the_loss():
    """``launch.train.train`` on the reduced jamba at q = 2 under AdamW
    and ``vfb2_sgd``: finite losses, AdamW's falling by more than 0.05
    (``examples/train_lm.py``'s threshold)."""
    losses = ttrain.train(ARCH, 12, 4, 32, 3e-3, log_every=100,
                          model_parallel=2, device="cpu")
    assert np.isfinite(losses).all()
    assert losses[0] - np.mean(losses[-3:]) > 0.05
    sgd = ttrain.train(ARCH, 3, 2, 16, 0.3, "vfb2_sgd", 3, log_every=100,
                       model_parallel=4, device="cpu")
    assert len(sgd) == 3 and np.isfinite(sgd).all()


# ---------------------------------------------------------------------------
# q = 4 against the reference on 4 devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _jax_q4_run(tmp_path_factory):
    """The reference on 4 forced host devices, at n_per = 2 under each
    dispatch mode, from its own ``init_params`` and ``make_batch`` (the
    same values as ``models(8)``'s): ``train_loss``, the prefill's token
    and last normed hidden state, and three decode steps from zeros
    (their tokens and normed hidden states, and the final cache).  It
    starts with the module's first test and runs beside the others;
    ``jax_q4`` waits for it."""
    if importlib.util.find_spec("jax") is None:   # a card's machine
        yield None
        return
    tmp = tmp_path_factory.mktemp("hybrid_q4")
    script = textwrap.dedent(f"""
        import dataclasses
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs.base import ShapeConfig, get_arch
        from repro.configs.inputs import make_batch
        from repro.launch.mesh import make_mesh_for
        from repro.models import model as jm
        from repro.sharding.api import Runtime, single_device_runtime
        from repro.sharding.api import use_runtime
        cfg = dataclasses.replace(get_arch({ARCH!r}).reduced(), n_layers=8)
        lm = jm.init_params(cfg, jax.random.PRNGKey(0))
        batch = make_batch(cfg, ShapeConfig("t", {S}, {B}, "train"),
                           single_device_runtime(), seed=3)
        out = {{}}

        def decode_hidden(rt, p, token, cache, pos, key):
            x = jm._embed_tokens(rt, cfg, p, token[:, None], key)[:, 0]
            for i in range(2):
                for j, kind in enumerate(cfg.period):
                    x, _, _ = jm._block_decode(
                        rt, cfg, kind,
                        jax.tree.map(lambda a: a[i], p["periods"][j]), x,
                        jax.tree.map(lambda a: a[i], cache[j]), pos, None)
            return jm.rms_norm(x, p["final_norm"])

        for disp in ("replicated", "alltoall"):
            rt = Runtime(mesh=make_mesh_for(4, 4), batch_axes=("data",),
                         attn_chunk=32, loss_chunk=16, moe_dispatch=disp)
            with use_runtime(rt):
                loss = jax.jit(lambda p, b: jm.train_loss(
                    rt, cfg, p, b, jax.random.PRNGKey(1)))(lm, batch)
                key = jax.random.PRNGKey(0)
                tok, kv = jax.jit(lambda p, b: jm.prefill(
                    rt, cfg, p, b, key))(lm, {{"tokens": batch["tokens"]}})
                x = jm._embed_tokens(rt, cfg, lm, batch["tokens"], key)
                h = jax.jit(lambda p, x: jm._backbone(
                    rt, cfg, p, x, x.shape[1])[0][:, -1])(lm, x)
                cache = jm.init_cache(rt, cfg, {B}, 8)
                dec = jax.jit(lambda p, b, k: jm.decode_step(
                    rt, cfg, p, b, k))
                hid = jax.jit(lambda p, t, c, pos, k: decode_hidden(
                    rt, p, t, c, pos, k))
                for t in range(3):
                    k = jax.random.PRNGKey(t)
                    token = batch["tokens"][:, t]
                    pos = jnp.asarray(t, jnp.int32)
                    out[f"dh_{{disp}}_{{t}}"] = np.asarray(hid(
                        lm, token, cache, pos, k).astype(jnp.float32))
                    nt, cache = dec(lm, {{"token": token, "pos": pos,
                                          "cache": cache}}, k)
                    out[f"dtok_{{disp}}_{{t}}"] = np.asarray(nt)
            assert kv is None
            out["loss_" + disp] = np.asarray(loss)
            out["tok_" + disp] = np.asarray(tok)
            out["h_" + disp] = np.asarray(h.astype(jnp.float32))
            for j, c in enumerate(cache):
                for n, v in c.items():
                    out[f"cache_{{disp}}_{{j}}_{{n}}"] = np.asarray(
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


@pytest.mark.parametrize("dispatch", ["replicated", "alltoall"])
def test_q4_matches_jax_on_4_devices(jx, models, jax_q4, dispatch):
    """The reduced jamba at n_per = 2 and q = 4 under each dispatch mode
    against the reference's 4-device run: ``train_loss`` (under
    ``alltoall`` with party 0's aux, C.R5), the prefill's token (no
    cache, C.R6), and three decode steps from zeros over the 4 parties'
    cache shards, their tokens and final cache."""
    m = models(8)
    rt = _rt(4, moe_dispatch=dispatch, attn_chunk=32, loss_chunk=16)
    batch = _tbatch(m)
    with torch.no_grad():
        loss = tm.train_loss(dataclasses.replace(
            rt, scan_impl="reference", attn_impl="reference"), m["cfg"],
            m["port"][4], batch, _gen())
        tok, kv = tm.prefill(rt, m["cfg"], m["port"][4],
                             {"tokens": batch["tokens"]}, _gen())
        cache = tm.init_cache(rt, m["cfg"], B, 8, device="cpu")
        dec, logits, want = [], [], []
        for t in range(3):
            nt, cache = tm.decode_step(rt, m["cfg"], m["port"][4],
                                       {"token": batch["tokens"][:, t],
                                        "pos": t, "cache": cache}, _gen(t))
            dec.append(nt.numpy())
            want.append(jax_q4[f"dtok_{dispatch}_{t}"])
            logits.append(_jax_logits(jx, m["jax"]["embed"],
                                      jax_q4[f"dh_{dispatch}_{t}"]))
    assert abs(float(loss) - float(jax_q4["loss_" + dispatch])) <= LOSS_TOL
    assert kv is None
    h = jax_q4["h_" + dispatch]
    _assert_tokens(tok.numpy(), jax_q4["tok_" + dispatch],
                   _jax_logits(jx, m["jax"]["embed"], h))
    _assert_tokens(np.stack(dec), np.stack(want), np.stack(logits))
    for j, entry in enumerate(cache):
        for n, v in entry.items():
            _assert_rel(v, jax_q4[f"cache_{dispatch}_{j}_{n}"], HIDDEN_REL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layers", LAYERS)
def test_cuda_hybrid_serve_launches(cuda_device, layers):
    """Serving the reduced jamba on the card launches the scan once per
    SSM layer of the prefill, flash attention once per attention layer of
    the prefill and decode attention once per attention layer of each
    decode step, and nothing else; a second call repeats the tokens."""
    cfg = _cfg(layers)
    n_attn = tm.layer_kinds(cfg).count("attn_mlp")
    kw = dict(batch=2, prompt_len=32, gen_tokens=4, model_parallel=4,
              seed=0, device=cuda_device, n_layers=layers)
    for lib in (vg.KERNEL, ss.KERNEL, fa.KERNEL, da.KERNEL):
        lib.reset_launches()
    res = serve(ARCH, **kw)
    torch.cuda.synchronize()
    assert ss.KERNEL.launches["selective_scan"] == layers - n_attn
    assert fa.KERNEL.launches["flash_attention"] == n_attn
    assert da.KERNEL.launches["decode_attention"] == n_attn * 3
    assert not any(vg.KERNEL.launches.values())
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    assert all(torch.isfinite(v.float()).all()
               for entry in res.cache for v in entry.values())
    np.testing.assert_array_equal(serve(ARCH, **kw).tokens, res.tokens)


@pytest.mark.cuda
def test_cuda_hybrid_kernel_routes_match_plain(cuda_device):
    """On the card, layer by layer in the period's order, each mixer's
    kernel route (the scan kernel, flash attention) within
    ``HIDDEN_REL`` of its plain route (the scan oracle, the chunked
    attention) on the same normed input; the stream advances on the
    kernel routes.  (End to end the two routes' hidden states part where
    a bf16 rounding flips a token's experts, so the layers are compared
    one at a time.)"""
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.layers import rms_norm
    cfg = _cfg(8)
    params = tm.init_params(cfg, 0, device=cuda_device)
    batch = make_batch(cfg, ShapeConfig("t", 64, 2, "prefill"), _rt(4),
                       device=cuda_device)
    kern, plain = _rt(4), _rt(4, scan_impl="reference",
                              attn_impl="reference")
    with torch.no_grad():
        x = tm._embed_tokens(kern, cfg, params, batch["tokens"],
                             mask_generator(0, device=cuda_device))
        for i, kind, p in tm._blocks(cfg, params):
            h = rms_norm(x, p["norm1"])
            if kind.startswith("attn"):
                outs = [tm._apply_attention(rt, cfg, p["attn"], h, 64)[0]
                        for rt in (kern, plain)]
            else:
                outs = [ssm_lib.apply_ssm(p["ssm"], h, scan_impl=impl)
                        for impl in ("kernel", "reference")]
            _assert_rel(outs[0].cpu(), outs[1].cpu(), HIDDEN_REL)
            x, _ = tm._block_fwd(kern, cfg, kind, p, x, 64)
    assert torch.isfinite(x.float()).all()
