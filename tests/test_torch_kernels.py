"""The port's ``vfl_grad`` (forward mode) against the JAX kernel.

On the CPU the port's wrapper runs its plain version; it is held against
the Pallas kernel in interpret mode (``repro.kernels.ops.vfl_grad``) and
against ``repro.kernels.ref.vfl_grad_ref`` at z atol = rtol = 1e-4, the
bound of ``tests/test_kernels.py``.  The CUDA kernel itself runs only on
a card: its test is marked ``cuda`` and skips here.  JAX is imported
inside fixtures, so the file also runs where only the port is installed:
``python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import vfl_grad as vg

TOL = dict(atol=1e-4, rtol=1e-4)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def jnp():
    import jax.numpy
    return jax.numpy


@pytest.fixture
def jops():
    from repro.kernels import ops as jax_ops
    return jax_ops


@pytest.fixture
def jref():
    from repro.kernels import ref as jax_ref
    return jax_ref


def _pair(jnp, a, dtype):
    """The same values in both frameworks (bf16 rounding is identical)."""
    return (torch.from_numpy(a).to(DTYPES[dtype]),
            jnp.asarray(a).astype({"f32": jnp.float32,
                                   "bf16": jnp.bfloat16}[dtype]))


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,d,m", [
    (64, 512, None),     # linear serve: request rows against one column
    (128, 256, 1),
    (100, 200, 2),       # ragged B, D
    (32, 7, 1),          # tiny odd party block
    (96, 130, 4),
    (1, 33, 64),         # the reference's serve orientation: M = requests
    (64, 512, 32),       # deep serve, first encoder layer
    (64, 32, 16),        # deep serve, second encoder layer
])
def test_forward_matches_jax(jnp, jops, dtype, b, d, m):
    x_np = _rand(1, (b, d))
    w_np = _rand(2, (d,) if m is None else (d, m))
    xt, xj = _pair(jnp, x_np, dtype)
    wt, wj = _pair(jnp, w_np, dtype)
    z, g = ops.vfl_grad(xt, wt, mode="forward")
    zj, gj = jops.vfl_grad(xj, wj, None, mode="forward", interpret=True)
    assert g is None and gj is None
    assert z.dtype == torch.float32
    assert tuple(z.shape) == tuple(zj.shape) == \
        ((b,) if m is None else (b, m))
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), **TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m", [None, 1, 5])
def test_party_axis_matches_per_party_jax(jnp, jops, dtype, m):
    """One call over a leading party axis equals the reference's kernel
    run party by party (the JAX engine's vmap)."""
    p, b, d = 3, 37, 100
    x_np = _rand(3, (p, b, d))
    w_np = _rand(4, (p, d) if m is None else (p, d, m))
    xt, xj = _pair(jnp, x_np, dtype)
    wt, wj = _pair(jnp, w_np, dtype)
    z, _ = ops.vfl_grad(xt, wt, mode="forward")
    assert tuple(z.shape) == ((p, b) if m is None else (p, b, m))
    for i in range(p):
        zj, _ = jops.vfl_grad(xj[i], wj[i], None, mode="forward",
                              interpret=True)
        np.testing.assert_allclose(z[i].numpy(), np.asarray(zj), **TOL)


@pytest.mark.parametrize("m", [None, 3])
def test_ref_matches_jax_ref(jnp, jref, m):
    b, d = 40, 24
    x = _rand(5, (b, d))
    w = _rand(6, (d,) if m is None else (d, m))
    th = _rand(7, (b,) if m is None else (b, m))
    z, g = ref.vfl_grad_ref(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(th), 0.01)
    zj, gj = jref.vfl_grad_ref(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(th), 0.01)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(ref.vfl_forward_ref(torch.from_numpy(x),
                                                   torch.from_numpy(w)),
                               z.numpy())


@pytest.mark.parametrize("kw", [dict(mode="backward"), dict(mode="fused"),
                                dict(mode="fused", split=8)])
def test_unported_modes_raise(kw):
    x = torch.ones((16, 8))
    with pytest.raises(NotImplementedError, match="B1"):
        ops.vfl_grad(x, torch.ones(8), torch.ones(16), **kw)


@pytest.mark.parametrize("xs,ws,wdt", [
    ((4, 8), (9,), torch.float32),          # contraction mismatch
    ((4, 8), (8,), torch.bfloat16),         # mixed dtypes
    ((2, 4, 8), (3, 8), torch.float32),     # party count mismatch
    ((2, 4, 8), (8,), torch.float32),       # party axis needs per-party w
])
def test_bad_operands_raise(xs, ws, wdt):
    with pytest.raises(ValueError):
        ops.vfl_grad(torch.ones(xs), torch.ones(ws, dtype=wdt))


def test_cpu_never_launches_the_kernel():
    before = dict(vg.KERNEL.launches)
    ops.vfl_grad(torch.ones((3, 4, 8)), torch.ones((3, 8)))
    ops.vfl_grad(torch.ones((3, 4, 8)), torch.ones((3, 8, 16)))
    assert vg.KERNEL.launches == before
    assert set(before) == set(vg.PROGRAMS)
    assert vg.KERNEL._lib is None, "CPU tensors must not build the kernel"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64, 512, 0), (1, 64, 512, 0),
                                   (8, 64, 512, 32), (8, 64, 32, 16),
                                   (5, 19, 70, 4), (5, 19, 70, 5),
                                   (3, 37, 333, 21)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, shape):
    p, b, d, m = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((p, b, d), generator=gen, device=cuda_device).to(dtype)
    w = torch.randn((p, d) if m == 0 else (p, d, m), generator=gen,
                    device=cuda_device).to(dtype)
    before = dict(vg.KERNEL.launches)
    z, _ = ops.vfl_grad(x, w, mode="forward")
    torch.cuda.synchronize()
    prog = vg.PROGRAMS[0] if max(m, 1) <= vg.NARROW_MAX_M else vg.PROGRAMS[1]
    assert vg.KERNEL.launches == {**before, prog: before[prog] + 1}
    torch.testing.assert_close(z, ref.vfl_forward_ref(x, w), **TOL)
