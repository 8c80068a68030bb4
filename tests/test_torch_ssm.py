"""The port's selective scan and mamba block against the JAX package.

Inputs are made with numpy from a seed and go through both packages.  The
port's ``ops.selective_scan`` on CPU tensors runs its plain version; it is
held against the Pallas kernel in interpret mode
(``repro.kernels.ops.selective_scan``) at the tolerances of
``tests/test_kernels.py``: 1e-4 for f32 xa, 5e-2 for bf16.  The block's
tolerances are relative to the largest reference value:

* f32 activations: the JAX block then runs wholly in f32, so 1e-5 (float
  rounding in another summation order);
* bf16 activations: 1e-2, a little over one bf16 ulp (2⁻⁷) at the top of
  the output's range, since the two frameworks round bf16 products and
  sums at different places.

The CUDA kernel runs only on a card: those tests are marked ``cuda`` and
skip here.  JAX is imported inside fixtures, so on a machine with the port
alone ``python -m pytest -q --noconftest -m cuda tests/test_torch_ssm.py``
runs them.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as ss
from repro_torch.models import ssm as tssm

SCAN_TOL = {"f32": 1e-4, "bf16": 5e-2}
BLOCK_REL = {"f32": 1e-5, "bf16": 1e-2}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
SWEEP = [(1, 64, 128, 8), (2, 128, 256, 16), (1, 32, 512, 4)]
SWEEP_TILES = [(16, 64), (32, 128), (32, 256)]   # Pallas chunk, block_c


@pytest.fixture
def jnp():
    import jax.numpy
    return jax.numpy


@pytest.fixture
def jax_ssm():
    from repro.models import ssm
    return ssm


def _scan_inputs(seed, b, s, c, n, random_a=False):
    """xa, dt = softplus(normal), b, c, d_skip normal; a_log = log(1..n) in
    every channel (mamba's initialisation) or, with ``random_a``, the log
    of uniform [0.5, 16] drawn per (channel, state), as trained weights
    have: exp(dt A) then shares no power structure across the states."""
    rng = np.random.default_rng(seed)
    xa = rng.standard_normal((b, s, c)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, c)), 0).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    if random_a:
        a_log = np.log(rng.uniform(0.5, 16.0, (c, n))).astype(np.float32)
    else:
        a_log = np.log(np.tile(np.arange(1, n + 1, dtype=np.float32),
                               (c, 1)))
    d_skip = rng.standard_normal(c).astype(np.float32)
    return xa, dt, bm, cm, a_log, d_skip


def _torch_args(args, dtype):
    xa, *rest = (torch.from_numpy(a) for a in args)
    return (xa.to(DTYPES[dtype]), *rest)


def _jax_args(jnp, args, dtype):
    xa, *rest = (jnp.asarray(a) for a in args)
    return (xa.astype({"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]),
            *rest)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else a.astype("float32"), np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,tiles", list(zip(SWEEP, SWEEP_TILES)))
def test_plain_scan_matches_jax_kernel(jnp, dtype, shape, tiles):
    from repro.kernels import ops as jops
    args = _scan_inputs(1, *shape)
    y = ops.selective_scan(*_torch_args(args, dtype))
    yj = jops.selective_scan(*_jax_args(jnp, args, dtype), chunk=tiles[0],
                             block_c=tiles[1], interpret=True)
    assert y.dtype == DTYPES[dtype] and tuple(y.shape) == shape[:3]
    tol = SCAN_TOL[dtype]
    np.testing.assert_allclose(_f32(y), _f32(yj), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,tiles", list(zip(SWEEP, SWEEP_TILES)))
def test_plain_scan_random_a_matches_jax_kernel(jnp, dtype, shape, tiles):
    """As above with a_log drawn per (channel, state): a kernel that
    relied on A = -(1..N) in every channel would fail here."""
    from repro.kernels import ops as jops
    args = _scan_inputs(9, *shape, random_a=True)
    y = ops.selective_scan(*_torch_args(args, dtype))
    yj = jops.selective_scan(*_jax_args(jnp, args, dtype), chunk=tiles[0],
                             block_c=tiles[1], interpret=True)
    tol = SCAN_TOL[dtype]
    np.testing.assert_allclose(_f32(y), _f32(yj), atol=tol, rtol=tol)


def test_wrapper_constants_match_source():
    """The wrapper refuses what the CUDA source's launcher refuses: the
    state sizes it has instances for and the batch rows its grid takes."""
    import re
    text = ss.ScanKernel().source.read_text()
    launcher = text[text.index("int launch(const void*"):]
    assert tuple(int(n) for n in re.findall(r"case (\d+):", launcher)) \
        == ss.STATE_SIZES
    assert re.findall(r"constexpr int kMaxRows = (\d+);", text) \
        == [str(ss.MAX_ROWS)]


@pytest.mark.parametrize("shape", [(2, 37, 75, 8), (3, 5, 130, 16),
                                   (1, 1, 1, 4)])
def test_ragged_scan_and_state_match_jax_oracle(jnp, jax_ssm, shape):
    """S and C that no Pallas tiling divides, and the oracle's final state
    from a given h0."""
    args = _scan_inputs(2, *shape)
    h0 = np.random.default_rng(3).standard_normal(
        (shape[0], shape[2], shape[3])).astype(np.float32)
    y, h = tssm.selective_scan_ref(*_torch_args(args, "f32"),
                                   h0=torch.from_numpy(h0))
    yj, hj = jax_ssm.selective_scan_ref(*_jax_args(jnp, args, "f32"),
                                        h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=1e-4,
                               rtol=1e-4)
    y0 = ops.selective_scan(*_torch_args(args, "f32"))
    np.testing.assert_array_equal(
        y0.numpy(), ref.selective_scan_state(*_torch_args(args, "f32"))[0])


@pytest.mark.parametrize("bad", ["n", "dt_shape", "a_log_rank", "dtype",
                                 "device"])
def test_scan_bad_operands_raise(bad):
    args = list(_torch_args(_scan_inputs(0, 1, 4, 8, 4), "f32"))
    if bad == "n":
        args[2] = args[2][..., :3]
    elif bad == "dt_shape":
        args[1] = args[1][:, :3]
    elif bad == "a_log_rank":
        args[4] = args[4][:, 0]
    elif bad == "dtype":
        args[0] = args[0].double()
    else:
        args[5] = args[5].to("meta")
    with pytest.raises(ValueError):
        ops.selective_scan(*args)


def test_cpu_never_launches_the_kernel():
    before = dict(ss.KERNEL.launches)
    ops.selective_scan(*_torch_args(_scan_inputs(0, 2, 9, 16, 8), "bf16"))
    assert ss.KERNEL.launches == before
    assert set(before) == set(ss.PROGRAMS) == {"selective_scan"}
    assert ss.KERNEL._lib is None, "CPU tensors must not build the kernel"


# ---------------------------------------------------------------------------
# the mamba block, with the reduced falcon-mamba's layer 0 carried across
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block_params():
    """(JAX layer-0 block params, the port's) from the reference's reduced
    falcon-mamba, carried by ``convert.lm_params``."""
    import jax
    from repro.configs.base import get_arch
    from repro.models import model as jax_model
    from repro_torch import convert
    cfg = get_arch("falcon_mamba_7b").reduced()
    params = jax.tree.map(np.asarray,
                          jax_model.init_params(cfg, jax.random.PRNGKey(0)))
    ported = convert.lm_params(params, q=1, device="cpu")
    pj = jax.tree.map(lambda a: jax.numpy.asarray(a[0]),
                      params["stack"]["ssm"])
    pt = {k: v[0] for k, v in ported["stack"]["ssm"].items()}
    return pj, pt, cfg


def _assert_rel(got, want, rel):
    want = _f32(want)
    err = np.abs(_f32(got) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl", [("kernel", "pallas"),
                                  ("reference", "reference")])
def test_apply_ssm_matches_jax(jnp, jax_ssm, block_params, dtype, impl):
    pj, pt, cfg = block_params
    x = np.random.default_rng(4).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    xt, xj = _torch_args((x,), dtype)[0], _jax_args(jnp, (x,), dtype)[0]
    out = tssm.apply_ssm(pt, xt, scan_impl=impl[0])
    outj = jax_ssm.apply_ssm(pj, xj, scan_impl=impl[1])
    assert out.dtype == xt.dtype and tuple(out.shape) == x.shape
    _assert_rel(out, outj, BLOCK_REL[dtype])


def test_apply_ssm_rejects_unknown_scan_impl(block_params):
    _, pt, cfg = block_params
    with pytest.raises(ValueError):
        tssm.apply_ssm(pt, torch.zeros((1, 2, cfg.d_model)),
                       scan_impl="pallas")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_causal_conv_with_carried_state_matches_jax(jnp, jax_ssm, dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    state = rng.standard_normal((2, 3, 24)).astype(np.float32)
    xt, st = _torch_args((x,), dtype)[0], _torch_args((state,), dtype)[0]
    xj, sj = _jax_args(jnp, (x,), dtype)[0], _jax_args(jnp, (state,),
                                                       dtype)[0]
    y, new = tssm._causal_conv(xt, torch.from_numpy(w),
                               torch.from_numpy(bias), state=st)
    yj, newj = jax_ssm._causal_conv(xj, jnp.asarray(w), jnp.asarray(bias),
                                    state=sj)
    _assert_rel(y, yj, BLOCK_REL[dtype])
    np.testing.assert_array_equal(_f32(new), _f32(newj))
    y0, _ = tssm._causal_conv(xt, torch.from_numpy(w),
                              torch.from_numpy(bias))
    y0j, _ = jax_ssm._causal_conv(xj, jnp.asarray(w), jnp.asarray(bias))
    _assert_rel(y0, y0j, BLOCK_REL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_ssm_decode_matches_jax(jnp, jax_ssm, block_params, dtype):
    """Three decode steps from a random state, each against the JAX step
    on the JAX state (so errors do not compound)."""
    pj, pt, cfg = block_params
    s = cfg.ssm
    ci = s.expand * cfg.d_model
    rng = np.random.default_rng(6)
    cache = tssm.init_ssm_cache(2, cfg.d_model, s.d_state, s.d_conv,
                                s.expand, device="cpu")
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["h"].dtype == torch.float32
    conv = rng.standard_normal((2, s.d_conv - 1, ci)).astype(np.float32)
    h = 0.1 * rng.standard_normal((2, ci, s.d_state)).astype(np.float32)
    cj = {"conv": jnp.asarray(conv).astype(jnp.bfloat16),
          "h": jnp.asarray(h)}
    for step in range(3):
        x = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
        conv_dtype = DTYPES["bf16" if cj["conv"].dtype == jnp.bfloat16
                            else "f32"]
        ct = {"conv": torch.from_numpy(np.array(
            cj["conv"].astype(jnp.float32))).to(conv_dtype),
            "h": torch.from_numpy(np.array(cj["h"]))}
        out, new = tssm.apply_ssm_decode(pt, _torch_args((x,), dtype)[0],
                                         ct)
        outj, cj = jax_ssm.apply_ssm_decode(pj, _jax_args(jnp, (x,),
                                                          dtype)[0], cj)
        # the conv context takes x's dtype (bf16 in the model), h is f32
        assert new["conv"].dtype == DTYPES[dtype]
        assert str(cj["conv"].dtype) == {"f32": "float32",
                                         "bf16": "bfloat16"}[dtype]
        assert new["h"].dtype == torch.float32
        _assert_rel(out, outj, BLOCK_REL[dtype])
        _assert_rel(new["h"], cj["h"], BLOCK_REL[dtype])
        _assert_rel(new["conv"], cj["conv"], BLOCK_REL[dtype])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


CUDA_SHAPES = SWEEP + [(3, 100, 300, 8), (2, 517, 1000, 16),
                      (4, 1024, 2048, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("random_a", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, dtype, shape, random_a):
    """The kernel against its plain version on the card at the sweep
    shapes, ragged S and C, and a wide one, at the scan tolerances, with
    mamba's a_log and with a_log drawn per (channel, state)."""
    args = _torch_args(_scan_inputs(7, *shape, random_a=random_a), dtype)
    args = [a.to(cuda_device) for a in args]
    before = ss.KERNEL.launches["selective_scan"]
    y = ops.selective_scan(*args)
    want = ref.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss.KERNEL.launches["selective_scan"] == before + 1
    assert y.dtype == want.dtype and y.shape == want.shape
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(y.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_kernel_refuses_other_state_sizes(cuda_device):
    args = [a.to(cuda_device) for a in
            _torch_args(_scan_inputs(8, 1, 4, 8, 12), "f32")]
    with pytest.raises(ValueError):
        ops.selective_scan(*args)


def _misaligned(t):
    """A contiguous copy of t at a storage offset of one element, so its
    data pointer is off the 16-byte copy width."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 128, 256, 16), (3, 100, 300, 8),
                                   (4, 1024, 2048, 16)])
def test_cuda_kernel_repeats_bit_for_bit(cuda_device, dtype, shape):
    """No atomics and a fixed order of the lanes' partials: two calls give
    the same bits, and so do operands off the 16-byte copy width (staged
    element by element into the same layout)."""
    args = [a.to(cuda_device) for a in
            _torch_args(_scan_inputs(10, *shape, random_a=True), dtype)]
    first, again = (ops.selective_scan(*args) for _ in range(2))
    for i in (0, 1, 2):
        moved = list(args)
        moved[i] = _misaligned(args[i])
        assert torch.equal(ops.selective_scan(*moved), first), i
    torch.cuda.synchronize()
    assert torch.equal(first, again)
