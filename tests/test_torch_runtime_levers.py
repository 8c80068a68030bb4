"""The ``Runtime`` levers of the LM stack: ``remat``, ``unroll_layers``
and ``seq_parallel_norms``, and the per-chunk checkpoint of
``chunked_attention``, on reduced configs of 2 to 12 layers.

* ``remat=True`` (the default) against ``remat=False`` in the port: the
  loss and every leaf's gradient bit-equal on every stack kind (dense
  with gemma3's windows, SSM, MoE under both dispatch modes, jamba's
  period stack, whisper's encoder-decoder, pixtral's patch prefix) at
  q = 1 and 4; the MoE layers' recomputation routes as their first pass;
  the bytes autograd keeps outside the checkpointed blocks fall to at
  most a quarter.
* ``chunked_attention``: gradients bit-equal to the loop without the
  checkpoint, and the bytes it keeps the same at every chunk count.
* ``unroll_layers=n`` against the reference's
  ``single_device_runtime(unroll_layers=n)`` on the reference's tree,
  carried across: ``train_loss`` at f32 activations without the mask
  residue within 1e-5, ``prefill``'s tokens and cache, three decode
  steps' tokens and caches, at the tolerances of
  ``tests/test_torch_lm.py`` (caches within ``HIDDEN_REL`` of the
  largest reference value, tokens wherever the reference's margin
  decides them).  A period stack's unrolled decode runs position-major,
  as the reference's does (ROADMAP C.R8).
* ``unroll_layers=n`` on the full tree bit-equal to the tree cut to n
  layers, for the uniform and encoder stacks.
* ``seq_parallel_norms=True`` bit-equal to off.
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_lm import HIDDEN_REL, _assert_rel, _assert_tokens, \
    _jax_logits

from repro_torch import convert
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.configs.inputs import make_batch
from repro_torch.core.secure_agg import mask_generator
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as attn_lib
from repro_torch.models import model as tm
from repro_torch.models import moe as moe_lib
from repro_torch.optim.tree import leaves, leaves_with_path, unflatten
from repro_torch.sharding.api import Runtime

B, S = 2, 32             # train_loss's batch
PB, PROMPT, CACHE, STEPS = 4, 24, 32, 3     # prefill and decode
# name: (architecture, fields replaced in its reduced config)
ARCHS = {"gemma3": ("gemma3_4b", dict(n_layers=4, global_every=2)),
         "falcon": ("falcon_mamba_7b", dict(n_layers=4)),
         "granite_moe": ("granite_moe_1b_a400m", dict(n_layers=4)),
         "jamba": ("jamba_v0_1_52b", dict(n_layers=8)),
         "jamba12": ("jamba_v0_1_52b", dict(n_layers=12)),
         "whisper": ("whisper_tiny", {}),
         "pixtral": ("pixtral_12b", {})}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its ops are small, and
    the suite runs several test processes on one machine's cores, where
    more threads a process only contend.  The count is put back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    arch, kw = ARCHS[name]
    return dataclasses.replace(get_arch(arch).reduced(), **kw)


def _rt(q=1, **kw):
    return Runtime(model_size=q, **dict(dict(
        attn_chunk=8, loss_chunk=8, scan_impl="reference",
        attn_impl="reference"), **kw))


def _gen(seed=0):
    return mask_generator(seed, device="cpu")


def _batch(cfg, mode="train", s=S, b=B, seed=0):
    return make_batch(cfg, ShapeConfig("t", s, b, mode), _rt(), seed=seed,
                      device="cpu")


@pytest.fixture(scope="module")
def port_params():
    built = {}

    def get(name):
        if name not in built:
            built[name] = tm.init_params(_cfg(name), 0, device="cpu")
        return built[name]
    return get


def _saved_bytes(fn, exclude=()):
    """(fn(), the bytes of the distinct storages autograd saves for the
    backward while fn runs, those of ``exclude`` left out).  Inside a
    checkpointed region the checkpoint's own hooks take the saved
    tensors, so only what is kept outside the regions is counted."""
    seen = {t.untyped_storage().data_ptr() for t in exclude}
    total = [0]

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total[0] += st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total[0]


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def test_runtime_takes_the_three_levers():
    """The reference's defaults (remat on), and ``launch.train`` trains
    with them."""
    rt = Runtime()
    assert rt.remat is True and rt.unroll_layers is None \
        and rt.seq_parallel_norms is False
    rt = Runtime(remat=False, unroll_layers=3, seq_parallel_norms=True)
    assert (rt.remat, rt.unroll_layers, rt.seq_parallel_norms) \
        == (False, 3, True)
    assert ttrain.build_runtime(2, reduced=True).remat is True


@pytest.mark.parametrize("n", [0, -1, 1.5])
def test_unroll_layers_below_one_raises(n):
    with pytest.raises(ValueError, match="unroll_layers"):
        Runtime(unroll_layers=n)


def test_paper_logreg_config_matches_jax():
    from repro.configs.base import get_arch as jget_arch
    cfg, jcfg = get_arch("paper_logreg"), jget_arch("paper_logreg")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.arch_type == "linear" and get_arch("paper-logreg") == cfg


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

REMAT_CASES = [("gemma3", "replicated"), ("falcon", "replicated"),
               ("granite_moe", "replicated"), ("granite_moe", "alltoall"),
               ("jamba", "replicated"), ("whisper", "replicated"),
               ("pixtral", "replicated")]


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("name,dispatch", REMAT_CASES)
def test_remat_loss_and_grads_bit_equal(port_params, monkeypatch, name,
                                        dispatch, q):
    """``train_loss`` and every leaf's gradient with each block
    checkpointed (a layer, jamba's period of 4, each encoder block) are
    the bits of the run that keeps every activation; an MoE layer's
    recomputation routes every token as its first pass did."""
    cfg, params = _cfg(name), port_params(name)
    batch = _batch(cfg, s=S // 2)
    routes = []
    route = moe_lib._route

    def recording(*args, **kw):
        out = route(*args, **kw)
        routes.append((out[0].clone(), out[1].detach().clone()))
        return out

    monkeypatch.setattr(moe_lib, "_route", recording)
    got = {}
    for remat in (False, True):
        routes.clear()
        loss, grads = ttrain.loss_and_grads(
            _rt(q, remat=remat, moe_dispatch=dispatch), cfg, params, batch,
            _gen(q))
        got[remat] = (loss, dict(leaves_with_path(grads)), list(routes))
    assert torch.equal(got[True][0], got[False][0])
    assert list(got[True][1]) == list(got[False][1])
    for path, g in got[False][1].items():
        assert torch.equal(got[True][1][path], g), path
    first, second = got[False][2], got[True][2]
    if cfg.moe is None:
        assert not first and not second
        return
    # the remat run routes each layer twice: in the forward, in the
    # forward's order, then again in the backward, the blocks in reverse
    assert len(first) > 0 and len(second) == 2 * len(first)
    again = second[len(first):]
    for a, b in zip(first, second):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for a in first:
        hit = [i for i, b in enumerate(again)
               if torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])]
        assert hit, "a layer's recomputation routed otherwise"
        again.pop(hit[0])


@pytest.mark.parametrize("name", ["gemma3", "falcon", "granite_moe",
                                  "whisper", "pixtral"])
def test_remat_saves_a_quarter_or_less(port_params, name):
    """At 4 layers (whisper: 2 encoder and 2 decoder blocks) the bytes
    ``train_loss`` leaves saved for the backward outside the checkpointed
    blocks are at most a quarter of those without remat."""
    cfg, params = _cfg(name), port_params(name)
    batch = _batch(cfg)
    saved = {}
    for remat in (False, True):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        _, saved[remat] = _saved_bytes(lambda: tm.train_loss(
            _rt(4, remat=remat), cfg, unflatten(params, iter(flat)), batch,
            _gen()), flat)
    assert 0 < saved[True] <= saved[False] / 4, saved


# ---------------------------------------------------------------------------
# chunked_attention's per-chunk checkpoint
# ---------------------------------------------------------------------------

def _qkv(seed=0, sq=32, skv=32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).requires_grad_()
            for shape in ((2, sq, 4, 8), (2, skv, 2, 8), (2, skv, 2, 8))]


def _unchecked(q, k, v, causal, window, chunk):
    """``chunked_attention``'s loop without the checkpoint."""
    b, sq, h, dh = q.shape
    kpos = torch.arange(k.shape[1])
    qr = q.reshape(b, sq // chunk, chunk, 2, h // 2, dh)
    return torch.stack([attn_lib._chunk_attention(
        qr[:, i], k.float(), v, i * chunk + torch.arange(chunk), kpos,
        causal, window, dh ** -0.5) for i in range(sq // chunk)],
        1).reshape(q.shape)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None)])
def test_chunked_attention_grads_bit_equal(causal, window):
    q, k, v = _qkv()
    ct = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad((attn_lib.chunked_attention(
        q, k, v, causal=causal, window=window, chunk=8) * ct).sum(),
        (q, k, v))
    want = torch.autograd.grad((_unchecked(q, k, v, causal, window, 8)
                                * ct).sum(), (q, k, v))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_chunked_attention_saved_bytes_do_not_grow_with_chunks():
    """The bytes it keeps beyond its inputs are the same at 1 to 16
    chunks (the query positions and the key positions), while the loop
    without the checkpoint keeps every chunk's probabilities."""
    q, k, v = _qkv(sq=64, skv=64)
    saved = {c: _saved_bytes(lambda: attn_lib.chunked_attention(
        q, k, v, chunk=c), (q, k, v))[1] for c in (64, 16, 8, 4)}
    assert len(set(saved.values())) == 1, saved
    _, plain = _saved_bytes(lambda: _unchecked(q, k, v, True, None, 8),
                            (q, k, v))
    probs = 2 * 4 * 64 * 64 * 4                   # B·H·Sq·Skv f32
    assert plain >= probs > 10 * saved[8], (plain, saved)


# ---------------------------------------------------------------------------
# unroll_layers against the reference
# ---------------------------------------------------------------------------

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
                get_arch=jget_arch, rt=single_device_runtime)


# name: (config, n)
UNROLL_CASES = {"dense": ("gemma3", 3), "ssm": ("falcon", 1),
                "period_1": ("jamba", 1), "period_2": ("jamba12", 2),
                "whisper": ("whisper", 1)}


def _jbatch(jx, jcfg, mode, s, b, seed=0):
    return jx["inputs"].make_batch(jcfg, jx["Shape"]("t", s, b, mode),
                                   jx["rt"](), seed=seed)


def _from_jax(a):
    """A reference input as the port's: tokens int64, frames bf16."""
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _to_port_cache(jcache, jnp, like):
    def one(entry, ref):
        return {k: torch.from_numpy(np.array(v.astype(jnp.float32)))
                .to(ref[k].dtype) for k, v in entry.items()}
    if isinstance(jcache, list):
        return [one(c, r) for c, r in zip(jcache, like)]
    return one(jcache, like)


def _entries(cache):
    return cache if isinstance(cache, list) else [cache]


@pytest.mark.parametrize("case", list(UNROLL_CASES))
def test_unroll_layers_matches_jax(jx, monkeypatch, case):
    """The reference's ``unroll_layers=n`` and the port's on the
    reference's full-depth tree: ``train_loss`` at f32 activations and
    the plain embedding within 1e-5; the prefill's tokens and its cache
    of n layers (no cache for the SSM and period stacks, C.R3, C.R6);
    three decode steps, the first on a full-depth cache of which the
    first n layers (periods) are read, each returning a cache of those
    only, the attention layers' as views of the given cache.  At n = 2
    periods both run the decode position-major (C.R8): there the port's
    unrolled step is not the period-major step of the tree cut to 2
    periods."""
    jax, jnp, jm = jx["jax"], jx["jnp"], jx["jm"]
    name, n = UNROLL_CASES[case]
    cfg = _cfg(name)
    arch, kw = ARCHS[name]
    jcfg = dataclasses.replace(jx["get_arch"](arch).reduced(), **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jrt = jx["rt"](attn_chunk=8, loss_chunk=8, unroll_layers=n)
    rt = _rt(1, unroll_layers=n)
    params_np = jax.tree.map(np.asarray,
                             jm.init_params(jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, params_np)
    params = convert.lm_params(params_np, q=1, device="cpu")

    # train_loss, f32 activations, no mask residue
    tb = _jbatch(jx, jcfg, "train", S, B, seed=3)
    saved = jm.ACT_DTYPE
    jm.ACT_DTYPE = jnp.float32
    try:
        want = float(jax.jit(lambda p, b: jm.train_loss(
            dataclasses.replace(jrt, secure_embed=False), jcfg, p, b,
            jax.random.PRNGKey(1)))(jp, tb))
    finally:
        jm.ACT_DTYPE = saved
    with monkeypatch.context() as m:
        m.setattr(tm, "ACT_DTYPE", torch.float32)
        got = float(tm.train_loss(
            dataclasses.replace(rt, secure_embed=False), cfg, params,
            {k: _from_jax(v) for k, v in tb.items()},
            _gen()))
    assert abs(got - want) <= 1e-5, (got, want)

    # prefill
    key = jax.random.PRNGKey(0)
    jb = _jbatch(jx, jcfg, "prefill", PROMPT, PB)
    pb = _batch(cfg, "prefill", PROMPT, PB)
    want_tok, jkv = jax.jit(lambda p, b, k: jm.prefill(jrt, jcfg, p, b, k))(
        jp, jb, key)
    got_tok, kv = tm.prefill(rt, cfg, params, pb, _gen())

    def last_hidden(p, b, k):
        x, enc_out, _ = jm._prepare_inputs(jrt, jcfg, p, b, k)
        return jm._backbone(jrt, jcfg, p, x, x.shape[1],
                            enc_out=enc_out)[0][:, -1]

    h = jax.jit(last_hidden)(jp, jb, key)
    _assert_tokens(got_tok.numpy(), np.asarray(want_tok),
                   _jax_logits(jx, jp["embed"], h))
    assert (kv is None) == (jkv is None)
    jcache = jm.init_cache(jrt, jcfg, PB, CACHE)
    if kv is not None:
        assert set(kv) == set(jkv)
        for k2, v in kv.items():
            assert v.shape[0] == n < cfg.n_layers
            assert tuple(v.shape) == jkv[k2].shape
            _assert_rel(v, jkv[k2], HIDDEN_REL)
        jcache = {k2: jax.lax.dynamic_update_slice(
            c, jkv[k2].astype(c.dtype), (0,) * c.ndim)
            for k2, c in jcache.items()}

    # three decode steps from the reference's caches
    like = tm.init_cache(rt, cfg, PB, CACHE, device="cpu")
    teacher = np.random.default_rng(1).integers(0, cfg.vocab, (PB, STEPS))
    jdecode = jax.jit(lambda p, b, k: jm.decode_step(jrt, jcfg, p, b, k))

    def decode_hidden(p, token, cache, pos, k):
        x = jm._embed_tokens(jrt, jcfg, p, token[:, None], k)[:, 0]
        x, _ = jm._decode_unrolled(jrt, jcfg, p, x, cache, pos)
        return jm.rms_norm(x, p["final_norm"])

    jhidden = jax.jit(decode_hidden)
    toks, want_toks, logits = [], [], []
    for t in range(STEPS):
        pos, k_t = PROMPT + t, jax.random.PRNGKey(t)
        token = jnp.asarray(teacher[:, t], jnp.int32)
        jstep = {"token": token, "pos": jnp.asarray(pos, jnp.int32),
                 "cache": jcache}
        want_t, jnext = jdecode(jp, jstep, k_t)
        cache = _to_port_cache(jcache, jnp, like)
        got_t, nxt = tm.decode_step(rt, cfg, params, {
            "token": torch.from_numpy(teacher[:, t]), "pos": pos,
            "cache": cache}, _gen(t))
        for j, (entry, given, jentry) in enumerate(zip(
                _entries(nxt), _entries(cache), _entries(jnext))):
            for k2, v in entry.items():
                assert v.shape[0] == n and tuple(v.shape) == jentry[k2].shape
                _assert_rel(v, jentry[k2], HIDDEN_REL)
                if "k" in entry:              # attention: written in place
                    assert v.data_ptr() == given[k2].data_ptr()
        hj = jhidden(jp, token, jcache, jnp.asarray(pos, jnp.int32), k_t)
        logits.append(_jax_logits(jx, jp["embed"], hj))
        toks.append(got_t.numpy())
        want_toks.append(np.asarray(want_t))
        jcache = jnext
    _assert_tokens(np.stack(toks), np.stack(want_toks), np.stack(logits))

    if case == "period_2":
        # C.R8: period-major on the tree cut to 2 periods is another step
        cut_cfg = dataclasses.replace(cfg, n_layers=8)
        cut = dict(params, periods=[{k2: _cut(v, 2) for k2, v in p.items()}
                                    for p in params["periods"]])
        start = tm.init_cache(_rt(), cut_cfg, PB, CACHE, device="cpu")
        step = {"token": torch.from_numpy(teacher[:, 0]), "pos": PROMPT}
        _, pm = tm.decode_step(_rt(), cut_cfg, cut, dict(
            step, cache=start), _gen())
        _, um = tm.decode_step(rt, cfg, params, dict(
            step, cache=tm.init_cache(rt, cfg, PB, CACHE, device="cpu")),
            _gen())
        # beyond the tolerance that holds the port to the reference
        assert any(float((a.float() - b.float()).abs().max())
                   > HIDDEN_REL * float(b.float().abs().max())
                   for e1, e2 in zip(pm, um)
                   for a, b in zip(leaves(e1), leaves(e2)))


def _cut(tree, n):
    if isinstance(tree, dict):
        return {k: _cut(v, n) for k, v in tree.items()}
    return tree[:n]


# ---------------------------------------------------------------------------
# unroll_layers on the full tree against the tree cut to n layers
# ---------------------------------------------------------------------------

CUT_CASES = {"dense": ("gemma3", 2), "ssm": ("falcon", 1),
             "whisper": ("whisper", 1)}


@pytest.mark.parametrize("case", list(CUT_CASES))
def test_unroll_layers_is_the_cut_tree(port_params, case):
    """``unroll_layers=n`` on the full tree gives the bits of the tree
    cut to its first n layers (whisper: n encoder and n decoder layers)
    with n_layers = n: ``train_loss`` and its gradients (zero beyond
    layer n), the prefill's tokens and cache, one decode step's token and
    cache."""
    name, n = CUT_CASES[case]
    cfg, params = _cfg(name), port_params(name)
    cut_cfg = dataclasses.replace(cfg, n_layers=n, enc_layers=min(
        n, cfg.enc_layers))
    cut = dict(params, stack=_cut(params["stack"], n))
    if cfg.enc_dec:
        cut["enc_stack"] = _cut(params["enc_stack"], n)
    full_rt, cut_rt = _rt(4, unroll_layers=n), _rt(4)

    batch = _batch(cfg)
    loss, grads = ttrain.loss_and_grads(full_rt, cfg, params, batch, _gen())
    cut_loss, cut_grads = ttrain.loss_and_grads(cut_rt, cut_cfg, cut, batch,
                                                _gen())
    assert torch.equal(loss, cut_loss)
    cut_g = dict(leaves_with_path(cut_grads))
    for path, g in leaves_with_path(grads):
        want = cut_g[path]
        if "stack" in path:
            assert torch.equal(g[:n], want) and not g[n:].any(), path
        else:
            assert torch.equal(g, want), path

    pb = _batch(cfg, "prefill", PROMPT, PB)
    outs = []
    for rt, c, p in ((full_rt, cfg, params), (cut_rt, cut_cfg, cut)):
        tok, kv = tm.prefill(rt, c, p, pb, _gen())
        cache = tm.init_cache(rt, c, PB, CACHE, device="cpu")
        if kv is not None:
            for k, v in kv.items():
                cache[k][:n, :, :v.shape[2]].copy_(v)
        tok2, nxt = tm.decode_step(rt, c, p, {"token": tok, "pos": PROMPT,
                                              "cache": cache}, _gen(1))
        outs.append((tok, kv, tok2, nxt))
    (a_tok, a_kv, a_tok2, a_nxt), (b_tok, b_kv, b_tok2, b_nxt) = outs
    assert torch.equal(a_tok, b_tok) and torch.equal(a_tok2, b_tok2)
    assert (a_kv is None) == (b_kv is None)
    for x, y in ((a_kv, b_kv), (a_nxt, b_nxt)):
        if x is not None:
            assert list(x) == list(y)
            assert all(torch.equal(x[k], y[k]) for k in x)


# ---------------------------------------------------------------------------
# seq_parallel_norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gemma3", "whisper"])
def test_seq_parallel_norms_changes_nothing(port_params, name):
    cfg, params = _cfg(name), port_params(name)
    out = []
    for spn in (False, True):
        rt = _rt(4, seq_parallel_norms=spn)
        loss = tm.train_loss(rt, cfg, params, _batch(cfg), _gen())
        tok, kv = tm.prefill(rt, cfg, params,
                             _batch(cfg, "prefill", PROMPT, PB), _gen())
        out.append((loss, tok, kv))
    (l0, t0, kv0), (l1, t1, kv1) = out
    assert torch.equal(l0, l1) and torch.equal(t0, t1)
    assert (kv0 is None) == (kv1 is None)
    if kv0 is not None:
        assert all(torch.equal(kv0[k], kv1[k]) for k in kv0)
