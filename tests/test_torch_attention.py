"""The port's attention functions and attention kernels against the JAX
package.

Inputs are made with numpy from a seed and go through both packages.
The plain functions of ``repro_torch.models.attention`` are held against
``repro.models.attention``; ``ops.flash_attention`` and
``ops.decode_attention`` on CPU tensors run their plain versions
(``kernels.ref``) and are held against the Pallas kernels in interpret
mode (``repro.kernels.ops``), as ``tests/test_kernels.py`` runs them.

Tolerances, with their reasons:

* attention functions: f32 2e-5 abs / 1e-4 rel (the reference's own
  integration pins, ``tests/test_vfl_integration.py:47-54``: f32 sums in
  another order); bf16 2e-2 (about two bf16 ulps at values of order 1:
  the frameworks round the bf16 probabilities and products at different
  places);
* ``flash_attention``: ``tests/test_kernels.py``'s sweep tolerances,
  2e-6 in f32 and 2e-2 in bf16;
* ``decode_attention``: ``tests/test_kernels.py``'s, the normalised
  output within 1e-5 in f32 and 3e-2 in bf16, the sum-exp l within 2e-4.

Tests marked ``cuda`` hold the CUDA kernels against their plain versions
on the card and skip here.  JAX is imported inside fixtures, so on a
machine with the port alone ``python -m pytest -q --noconftest -m cuda
tests/test_torch_attention.py`` runs them.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tat

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
FN_TOL = {"f32": dict(atol=2e-5, rtol=1e-4), "bf16": dict(atol=2e-2,
                                                          rtol=2e-2)}
FLASH_TOL = {"f32": 2e-6, "bf16": 2e-2}
DECODE_TOL = {"f32": 1e-5, "bf16": 3e-2}
# the decode kernel keeps P at f32 accuracy in P V, as the TPU kernel does:
# its normalised output stays this close to the plain version's at bf16
# too (P rounded to bf16 misses it by about 20x)
DECODE_P_TOL = 1e-4
# tests/test_kernels.py:16-39: (b, h, hkv, sq, skv, dh) and the masks
FLASH_SHAPES = [(1, 2, 2, 128, 128, 64), (2, 4, 2, 256, 256, 64),
                (1, 8, 1, 128, 256, 128), (2, 2, 2, 64, 64, 256)]
MASKS = [(True, None), (True, 96), (False, None)]
FLASH_CASES = [(s, c, w) for s in FLASH_SHAPES for c, w in MASKS
               if c or s[3] == s[4]]
DECODE_CASES = [(300, 0, None), (300, 0, 128), (700, 512, None)]


@pytest.fixture
def jnp():
    import jax.numpy
    return jax.numpy


@pytest.fixture
def jattn():
    from repro.models import attention
    return attention


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a, dtype):
    return torch.from_numpy(a).to(DTYPES[dtype])


def _j(jnp, a, dtype):
    return jnp.asarray(a).astype({"f32": jnp.float32,
                                  "bf16": jnp.bfloat16}[dtype])


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else a.astype("float32"), np.float32)


# ---------------------------------------------------------------------------
# the attention functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window,q_offset,chunk", [
    (True, None, 0, 16), (True, 16, 0, 32), (False, None, 0, 64),
    (True, 8, 4, 16)])
def test_chunked_and_reference_attention_match_jax(jnp, jattn, dtype, causal,
                                                   window, q_offset, chunk):
    q, k, v = _normal(0, (2, 64, 4, 32), (2, 68, 2, 32), (2, 68, 2, 32))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = tat.chunked_attention(*(_t(a, dtype) for a in (q, k, v)),
                                chunk=chunk, **kw)
    want = jattn.chunked_attention(*(_j(jnp, a, dtype) for a in (q, k, v)),
                                   chunk=chunk, **kw)
    assert got.dtype == DTYPES[dtype] and tuple(got.shape) == (2, 64, 4, 32)
    np.testing.assert_allclose(_f32(got), _f32(want), **FN_TOL[dtype])
    got = tat.reference_attention(*(_t(a, dtype) for a in (q, k, v)), **kw)
    want = jattn.reference_attention(*(_j(jnp, a, dtype) for a in (q, k, v)),
                                     **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), **FN_TOL[dtype])


def test_rope_positions_match_jax(jnp, jattn):
    (x,) = _normal(1, (2, 5, 4, 32))
    pos = np.array([[3, 7, 11, 0, 2]])
    got = tat.apply_rope_positions(_t(x, "bf16"), torch.from_numpy(pos),
                                   1e6)
    want = jattn.apply_rope_positions(_j(jnp, x, "bf16"), jnp.asarray(pos),
                                      1e6)
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pos,off,win", [(40, 0, None), (40, 0, 16),
                                         (70, 64, None), (10, 64, 8)])
def test_local_decode_attention_matches_jax(jnp, jattn, dtype, pos, off,
                                            win):
    q, kc, vc = _normal(2, (2, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32))
    got = tat.local_decode_attention(_t(q, dtype), _t(kc, dtype),
                                     _t(vc, dtype), pos, off, win)
    want = jattn.local_decode_attention(
        _j(jnp, q, dtype), _j(jnp, kc, dtype), _j(jnp, vc, dtype),
        jnp.asarray(pos), jnp.asarray(off),
        window=None if win is None else jnp.asarray(win, jnp.int32))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_f32(g), _f32(w), **FN_TOL[dtype])


def test_merge_partial_attention_matches_jax(jnp, jattn):
    """Over a leading shard axis, against the reference's pmax/psum merge
    run under ``vmap`` with that axis named; a shard with l = 0 and
    m = −1e30 (nothing valid) weighs nothing."""
    import jax
    o, m, l = _normal(3, (4, 2, 4, 32), (4, 2, 4), (4, 2, 4))
    l = np.abs(l)
    o[1], m[1], l[1] = 0.0, -1e30, 0.0
    got = tat.merge_partial_attention(*(torch.from_numpy(a)
                                        for a in (o, m, l)))
    want = jax.vmap(lambda a, b, c: jattn.merge_partial_attention(
        a, b, c, "shard"), axis_name="shard")(*(jnp.asarray(a)
                                                for a in (o, m, l)))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **FN_TOL["f32"])
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("pos,off", [(5, 0), (20, 16), (3, 16), (40, 16)])
def test_cache_scatter_matches_jax(jnp, jattn, pos, off):
    cache, new = _normal(4, (2, 16, 2, 8), (2, 2, 8))
    got = tat.cache_scatter(_t(cache, "bf16"), _t(new, "bf16"), pos, off)
    want = jattn.cache_scatter(_j(jnp, cache, "bf16"), _j(jnp, new, "bf16"),
                               jnp.asarray(pos), jnp.asarray(off))
    np.testing.assert_array_equal(_f32(got), _f32(want))


# ---------------------------------------------------------------------------
# ops.flash_attention (the plain version on CPU tensors)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,causal,window", FLASH_CASES)
def test_plain_flash_attention_matches_jax_kernel(jnp, dtype, shape, causal,
                                                  window):
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    b, h, hkv, sq, skv, dh = shape
    q, k, v = _normal(5, (b, h, sq, dh), (b, hkv, skv, dh),
                      (b, hkv, skv, dh))
    got = ops.flash_attention(*(_t(a, dtype) for a in (q, k, v)),
                              causal=causal, window=window)
    jargs = [_j(jnp, a, dtype) for a in (q, k, v)]
    want = jops.flash_attention(*jargs, causal=causal, window=window,
                                block_q=64, block_k=64, interpret=True)
    assert got.dtype == DTYPES[dtype] and tuple(got.shape) == (b, h, sq, dh)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _f32(got), _f32(jref.attention_ref(*jargs, causal=causal,
                                           window=window)),
        atol=tol, rtol=tol)


def test_flash_attention_strided_views_and_empty_rows(jnp):
    """Transposed (B, S, H, dh) views give the contiguous operands'
    result.  A window of 1 without the causal mask leaves the rows past
    Skv with no key: they give 0, as the Pallas kernel's do."""
    from repro.kernels import ops as jops
    q, k, v = _normal(6, (2, 48, 4, 32), (2, 40, 2, 32), (2, 40, 2, 32))
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = ops.flash_attention(qt, kt, vt, window=8)
    want = ops.flash_attention(qt.contiguous(), kt.contiguous(),
                               vt.contiguous(), window=8)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    out = ops.flash_attention(qt, kt, vt, causal=False, window=1)
    jout = jops.flash_attention(*(jnp.asarray(a).transpose(0, 2, 1, 3)
                                  for a in (q, k, v)), causal=False,
                                window=1, interpret=True)
    assert not out[:, :, 40:].any()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=FLASH_TOL["f32"], rtol=FLASH_TOL["f32"])


# ---------------------------------------------------------------------------
# ops.decode_attention (the plain version on CPU tensors)
# ---------------------------------------------------------------------------

def _normalised(o, l):
    return _f32(o) / np.maximum(_f32(l)[..., None], 1e-30)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pos,off,win", DECODE_CASES)
def test_plain_decode_attention_matches_jax_kernel(jnp, dtype, pos, off, win):
    """tests/test_kernels.py:356-379's cases."""
    from repro.kernels import ops as jops
    q, kc, vc = _normal(7, (2, 4, 64), (2, 512, 2, 64), (2, 512, 2, 64))
    got = ops.decode_attention(_t(q, dtype), _t(kc, dtype), _t(vc, dtype),
                               pos, off, win)
    want = jops.decode_attention(_j(jnp, q, dtype), _j(jnp, kc, dtype),
                                 _j(jnp, vc, dtype), pos, off, win,
                                 block_k=128, interpret=True)
    assert all(g.dtype == torch.float32 for g in got)
    tol = DECODE_TOL[dtype]
    np.testing.assert_allclose(_normalised(got[0], got[2]),
                               _normalised(want[0], want[2]), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(_f32(got[2]), _f32(want[2]), rtol=2e-4,
                               atol=2e-4)


def test_plain_decode_attention_fully_masked_shard(jnp):
    """A shard owning only future positions: l = 0 exactly, o = 0 and
    m = −1e30, as the reference kernel's test pins."""
    from repro.kernels import ops as jops
    q, kc, vc = _normal(8, (1, 2, 32), (1, 128, 2, 32), (1, 128, 2, 32))
    o, m, l = ops.decode_attention(*(torch.from_numpy(a) for a in
                                     (q, kc, vc)), pos=10, shard_offset=512)
    jo, jm, jl = jops.decode_attention(*(jnp.asarray(a) for a in
                                         (q, kc, vc)), pos=10,
                                       shard_offset=512, block_k=64,
                                       interpret=True)
    assert float(np.abs(np.asarray(jl)).max()) == 0.0
    assert not l.any() and not o.any()
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pos,off,win", [(90, 0, None), (250, 129, 40),
                                         (129, 129, 1)])
def test_plain_decode_attention_ragged_shard_matches_jax(jnp, jattn, dtype,
                                                         pos, off, win):
    """S_loc = 129, which no tiling divides (the JAX kernel asserts
    divisibility): against the reference's ``local_decode_attention``."""
    q, kc, vc = _normal(9, (2, 8, 32), (2, 129, 1, 32), (2, 129, 1, 32))
    got = ops.decode_attention(_t(q, dtype), _t(kc, dtype), _t(vc, dtype),
                               pos, off, win)
    want = jattn.local_decode_attention(
        _j(jnp, q, dtype), _j(jnp, kc, dtype), _j(jnp, vc, dtype),
        jnp.asarray(pos), jnp.asarray(off),
        window=None if win is None else jnp.asarray(win, jnp.int32))
    tol = DECODE_TOL[dtype]
    np.testing.assert_allclose(_normalised(got[0], got[2]),
                               _normalised(want[0], want[2]), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(_f32(got[2]), _f32(want[2]), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("shards,pos,win", [(4, 50, None), (4, 50, 12),
                                            (3, 7, None), (8, 95, 30)])
def test_decode_attention_shard_axis_merges_to_the_full_cache(shards, pos,
                                                              win):
    """The leading-shard-axis form: each shard equals a call on its own
    slice at its offset, and the merge equals one call over the whole
    cache."""
    q, kc, vc = (torch.from_numpy(a) for a in _normal(
        10, (2, 4, 32), (2, 96, 2, 32), (2, 96, 2, 32)))
    o, m, l = ops.decode_attention(q, kc, vc, pos, 0, win, shards=shards)
    assert o.shape == (shards, 2, 4, 32) and m.shape == l.shape == (
        shards, 2, 4)
    s_loc = 96 // shards
    for i in range(shards):
        one = ops.decode_attention(q, kc[:, i * s_loc:(i + 1) * s_loc],
                                   vc[:, i * s_loc:(i + 1) * s_loc], pos,
                                   i * s_loc, win)
        for got, want in zip((o[i], m[i], l[i]), one):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    fo, _, fl = ops.decode_attention(q, kc, vc, pos, 0, win)
    np.testing.assert_allclose(tat.merge_partial_attention(o, m, l).numpy(),
                               (fo / fl[..., None]).numpy(),
                               **FN_TOL["f32"])


def _bad_flash(bad):
    q, k, v = (torch.zeros(s) for s in ((1, 4, 8, 32), (1, 2, 8, 32),
                                        (1, 2, 8, 32)))
    args, kw = [q, k, v], {}
    if bad == "dtype":
        args[0] = q.double()
    elif bad == "heads":
        args[0] = q[:, :3]
    elif bad == "head_dim":
        args[1] = k[..., :16]
    elif bad == "window":
        kw["window"] = 0
    elif bad == "device":
        args[2] = v.to("meta")
    else:
        args[0] = q[0]
    return args, kw


def _bad_decode(bad):
    q, kc = torch.zeros((1, 4, 32)), torch.zeros((1, 8, 2, 32))
    args, kw = [q, kc, kc.clone(), 3], {}
    if bad == "dtype":
        args[0] = q.to(torch.bfloat16)
    elif bad == "heads":
        args[0] = q[:, :3]
    elif bad == "shards":
        kw["shards"] = 3
    elif bad == "window":
        kw["window"] = 0
    elif bad == "device":
        args[1] = kc.to("meta")
    else:
        args[0] = q[0]
    return args, kw


@pytest.mark.parametrize("op,bad", [
    (op, bad) for op in ("flash", "decode")
    for bad in ("dtype", "heads", "head_dim" if op == "flash" else "shards",
                "window", "device", "rank")])
def test_attention_ops_reject_bad_operands(op, bad):
    fn, make = ((ops.flash_attention, _bad_flash) if op == "flash"
                else (ops.decode_attention, _bad_decode))
    args, kw = make(bad)
    with pytest.raises(ValueError):
        fn(*args, **kw)


def test_cpu_never_launches_the_attention_kernels():
    before = (dict(fa.KERNEL.launches), dict(da.KERNEL.launches))
    q, k, v = (torch.zeros(s) for s in ((1, 2, 8, 32), (1, 1, 8, 32),
                                        (1, 1, 8, 32)))
    ops.flash_attention(q, k, v)
    ops.decode_attention(q[:, :, 0], k.transpose(1, 2), v.transpose(1, 2),
                         3, shards=2)
    assert (fa.KERNEL.launches, da.KERNEL.launches) == before
    assert set(before[0]) == {"flash_attention"}
    assert set(before[1]) == {"decode_attention"}
    assert fa.KERNEL._lib is None and da.KERNEL._lib is None, \
        "CPU tensors must not build the kernels"


# ---------------------------------------------------------------------------
# host-side pieces of the kernels' designs
# ---------------------------------------------------------------------------

def _valid_chunk_rows(s_loc, pos, offset, window, chunks, chunk_len):
    """The rows each block of a shard streams, as the decode kernel's
    ``block_span`` picks them: (chunk, first row, end row) for every chunk
    that holds a valid position."""
    lo = max(0, pos - window + 1 - offset)
    hi = min(s_loc, pos - offset + 1)
    if hi <= lo:
        return []
    return [(c, max(lo, c * chunk_len), min(hi, (c + 1) * chunk_len))
            for c in range(lo // chunk_len, (hi - 1) // chunk_len + 1)]


@pytest.mark.parametrize("s_loc", [1, 16, 63, 64, 65, 129, 516, 4096])
def test_decode_chunk_plan_covers_each_valid_position_once(s_loc):
    """``chunk_plan`` cuts a shard into non-empty chunks of at most
    ``CHUNK`` positions that cover it once, and the chunks a block takes
    for any pos and window cover exactly the valid positions, each once
    (so every partial the merge reads was written)."""
    chunks, chunk_len = da.chunk_plan(s_loc)
    assert 1 <= chunk_len <= da.CHUNK
    assert (chunks - 1) * chunk_len < s_loc <= chunks * chunk_len
    rng = np.random.default_rng(s_loc)
    for _ in range(40):
        offset = int(rng.integers(0, 3)) * s_loc
        pos = int(rng.integers(-2, offset + s_loc + 3))
        window = int(rng.choice([1, 3, 64, 100, 1 << 40]))
        spans = _valid_chunk_rows(s_loc, pos, offset, window, chunks,
                                  chunk_len)
        covered = [t for _, a, b in spans for t in range(a, b)]
        want = [t for t in range(s_loc)
                if pos - window < offset + t <= pos]
        assert covered == want
        assert all(a < b and 0 <= c < chunks for c, a, b in spans)


def _strided(shape, strides, dtype=torch.bfloat16):
    return torch.empty_strided(shape, strides, dtype=dtype)


@pytest.mark.parametrize("t,ok", [
    (_strided((2, 4, 8, 64), (2048, 512, 64, 1)), True),      # contiguous
    (_strided((2, 4, 8, 64), (2048, 64, 256, 1)), True),      # (B, S, H, dh)
    (_strided((1, 4, 8, 64), (8, 512, 64, 1)), True),         # a lone batch
    (_strided((2, 4, 8, 64), (2176, 544, 68, 1)), False),     # 136-byte rows
    (_strided((2, 4, 8, 64), (512, 0, 64, 1)), False),        # expanded heads
])
def test_flash_tma_ok_takes_what_tma_takes(t, ok):
    """The wgmma program's tensor maps take 16-byte multiples as strides,
    positive wherever a dimension has more than one element."""
    assert fa.tma_ok(t) is ok


def test_decode_counters_are_kept_for_good():
    """The merge's ticket counters: the newest buffer while it is large
    enough, else a larger one; none is dropped, since a captured graph
    may hold any of them."""
    kernel = da.DecodeKernel()
    cpu = torch.device("cpu")
    small = kernel.counters(cpu, 8)
    assert small.numel() >= 8 and not small.any()
    assert kernel.counters(cpu, small.numel()) is small
    big = kernel.counters(cpu, small.numel() + 1)
    assert big.numel() > small.numel() and not big.any()
    assert kernel.counters(cpu, 8) is big
    assert [t is u for t, u in zip(kernel._counters[None], (small, big))] \
        == [True, True]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _on(dev, dtype, *arrays):
    return [torch.from_numpy(a).to(dev, DTYPES[dtype]) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,causal,window",
                         FLASH_CASES + [((1, 4, 2, 1000, 1000, 128), True,
                                         None),
                                        ((2, 8, 4, 300, 300, 256), True,
                                         64),
                                        ((3, 4, 2, 77, 77, 32), True, 5)])
def test_cuda_flash_attention_matches_plain(cuda_device, dtype, shape,
                                            causal, window):
    b, h, hkv, sq, skv, dh = shape
    q, k, v = _on(cuda_device, dtype, *_normal(
        11, (b, h, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh)))
    before = fa.KERNEL.launches["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches["flash_attention"] == before + 1
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    tol = FLASH_TOL[dtype]
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.cuda
def test_cuda_flash_attention_reads_transposed_views(cuda_device):
    q, k, v = _on(cuda_device, "bf16", *_normal(
        12, (2, 200, 8, 256), (2, 200, 4, 256), (2, 200, 4, 256)))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    got = ops.flash_attention(qt, kt, vt, window=64)
    assert got.stride() == qt.stride()
    want = ops.flash_attention(qt.contiguous(), kt.contiguous(),
                               vt.contiguous(), window=64)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,pos,off,win,shards", [
    ((2, 4, 2, 512, 64), 300, 0, None, None),
    ((2, 4, 2, 512, 64), 300, 0, 128, None),
    ((2, 4, 2, 512, 64), 700, 512, None, None),
    ((1, 2, 2, 128, 32), 10, 512, None, None),        # fully masked
    ((4, 8, 4, 4128, 256), 4100, 0, None, 8),         # gemma3-4b, 516
    ((4, 8, 4, 4128, 256), 4100, 0, 1024, 8),
    ((2, 8, 1, 387, 128), 200, 0, 77, 3),             # ragged, rep 8
    ((3, 6, 1, 100, 64), 99, 0, None, 4)])            # rep 6
def test_cuda_decode_attention_matches_plain(cuda_device, dtype, shape, pos,
                                             off, win, shards):
    b, h, hkv, s, dh = shape
    q, kc, vc = _on(cuda_device, dtype, *_normal(
        13, (b, h, dh), (b, s, hkv, dh), (b, s, hkv, dh)))
    before = da.KERNEL.launches["decode_attention"]
    got = ops.decode_attention(q, kc, vc, pos, off, win, shards=shards)
    torch.cuda.synchronize()
    assert da.KERNEL.launches["decode_attention"] == before + 1
    want = ref.decode_attention_ref(q, kc, vc, pos, off, win, shards)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got[2], want[2], atol=2e-4, rtol=2e-4)
    norm = [t[0] / t[2].clamp(min=1e-30)[..., None] for t in (got, want)]
    torch.testing.assert_close(norm[0], norm[1], atol=tol, rtol=tol)
    assert float((norm[0] - norm[1]).abs().max()) <= DECODE_P_TOL
    masked = want[2] == 0
    assert torch.equal(got[2] == 0, masked)
    assert not got[0][masked].any()
    assert bool((got[1][masked] == -1e30).all())


@pytest.mark.cuda
def test_cuda_decode_attention_reads_pos_from_the_device(cuda_device):
    q, kc, vc = _on(cuda_device, "bf16", *_normal(
        14, (2, 4, 64), (2, 96, 2, 64), (2, 96, 2, 64)))
    pos = torch.tensor(50, dtype=torch.int32, device=cuda_device)
    a = ops.decode_attention(q, kc, vc, pos, 0, 20, shards=4)
    b = ops.decode_attention(q, kc, vc, 50, 0, 20, shards=4)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


# (b, h, hkv, s, dh), pos, window, shards: what each case covers
SPLIT_KV_CASES = {
    "window_start_inside_a_chunk": ((2, 4, 2, 512, 64), 300, 40, 2),
    "pos_on_a_shards_first_position": ((2, 4, 2, 512, 64), 256, None, 2),
    "pos_on_a_shards_last_position": ((2, 4, 2, 512, 64), 255, None, 2),
    "s_loc_not_a_multiple_of_the_chunk": ((2, 4, 2, 387, 128), 380, None,
                                          3),
    "window_shorter_than_a_chunk": ((2, 4, 2, 512, 64), 300, 3, 2),
    "window_of_one": ((1, 2, 1, 256, 256), 200, 1, 4),
    "many_chunks_per_shard": ((1, 2, 1, 4160, 32), 4100, None, 1),
}


def _decode_vs_plain(dev, dtype, shape, pos, win, shards, seed):
    b, h, hkv, s, dh = shape
    q, kc, vc = _on(dev, dtype, *_normal(seed, (b, h, dh), (b, s, hkv, dh),
                                         (b, s, hkv, dh)))
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    got = ops.decode_attention(q, kc, vc, pos_t, 0, win, shards=shards)
    again = ops.decode_attention(q, kc, vc, pos_t, 0, win, shards=shards)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q, kc, vc, pos, 0, win, shards)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got[2], want[2], atol=2e-4, rtol=2e-4)
    norm = [t[0] / t[2].clamp(min=1e-30)[..., None] for t in (got, want)]
    torch.testing.assert_close(norm[0], norm[1], atol=tol, rtol=tol)
    assert float((norm[0] - norm[1]).abs().max()) <= DECODE_P_TOL
    masked = want[2] == 0
    assert torch.equal(got[2] == 0, masked)
    assert not got[0][masked].any()
    assert bool((got[1][masked] == -1e30).all())
    for x, y in zip(got, again):              # the merge order is fixed
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(SPLIT_KV_CASES))
def test_cuda_decode_attention_split_kv_edges(cuda_device, dtype, case):
    shape, pos, win, shards = SPLIT_KV_CASES[case]
    _decode_vs_plain(cuda_device, dtype, shape, pos, win, shards, 15)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rep", [1, 2, 4, 6, 8])
def test_cuda_decode_attention_group_sizes(cuda_device, dtype, rep):
    _decode_vs_plain(cuda_device, dtype, (2, 2 * rep, 2, 520, 128), 500, 300,
                     4, 16)


@pytest.mark.cuda
def test_cuda_decode_attention_graph_replays_follow_the_device_pos(
        cuda_device):
    """One captured launch, replayed after pos moves on the device, gives
    what an eager call at that pos gives, bit for bit: the merge's ticket
    counters are back at 0 after every launch."""
    q, kc, vc = _on(cuda_device, "bf16", *_normal(
        17, (2, 4, 128), (2, 520, 2, 128), (2, 520, 2, 128)))
    pos = torch.tensor(300, dtype=torch.int32, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.decode_attention(q, kc, vc, pos, 0, 200, shards=4)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops.decode_attention(q, kc, vc, pos, 0, 200, shards=4)
    for p in (300, 301, 129, 130, 519, 5, 390, 300):
        pos.fill_(p)
        graph.replay()
        want = ops.decode_attention(q, kc, vc, p, 0, 200, shards=4)
        torch.cuda.synchronize()
        for x, y in zip(captured, want):
            assert torch.equal(x, y), p


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 5, 1000])
@pytest.mark.parametrize("rep", [1, 2, 4, 6])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_cuda_flash_attention_wgmma_program(cuda_device, dh, rep, window):
    """The wgmma program at every dh it serves, every group size (an odd
    rep takes 128 rows of one head a block, an even one pairs two heads)
    and 300 query rows: not a multiple of either query tile."""
    hkv = 2
    q, k, v = _on(cuda_device, "bf16", *_normal(
        18, (1, hkv * rep, 300, dh), (1, hkv, 300, dh), (1, hkv, 300, dh)))
    before = fa.KERNEL.launches["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches["flash_attention"] == before + 1
    want = ref.attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL["bf16"], rtol=FLASH_TOL["bf16"])


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
def test_cuda_flash_attention_tma_reads_transposed_views(cuda_device, dh):
    q, k, v = _on(cuda_device, "bf16", *_normal(
        19, (2, 200, 6, dh), (2, 200, 2, dh), (2, 200, 2, dh)))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    got = ops.flash_attention(qt, kt, vt, window=64)
    assert got.stride() == qt.stride()
    want = ops.flash_attention(qt.contiguous(), kt.contiguous(),
                               vt.contiguous(), window=64)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_strides_tma_cannot_take(cuda_device):
    """Rows 136 bytes apart: the wrapper raises, launches nothing and
    copies nothing."""
    (wide,) = _on(cuda_device, "bf16", *_normal(20, (1, 4, 64, 68)))
    q = wide[..., :64]
    k, v = _on(cuda_device, "bf16", *_normal(21, (1, 2, 64, 64),
                                             (1, 2, 64, 64)))
    before = fa.KERNEL.launches["flash_attention"]
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)
    assert fa.KERNEL.launches["flash_attention"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh", [("f32", 64), ("bf16", 32)])
def test_cuda_flash_attention_vector_load_programs_copy_odd_strides(
        cuda_device, dtype, dh):
    """The programs without TMA read operands whose strides are not
    multiples of 8 elements from a contiguous copy, as
    ``decode_attention`` does."""
    (wide,) = _on(cuda_device, dtype, *_normal(22, (1, 4, 64, dh + 4)))
    q = wide[..., :dh]
    k, v = _on(cuda_device, dtype, *_normal(23, (1, 2, 64, dh),
                                            (1, 2, 64, dh)))
    before = fa.KERNEL.launches["flash_attention"]
    got = ops.flash_attention(q, k, v)
    assert fa.KERNEL.launches["flash_attention"] == before + 1
    want = ops.flash_attention(q.contiguous(), k, v)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
