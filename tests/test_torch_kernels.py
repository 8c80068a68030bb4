"""The port's ``vfl_grad`` (forward, backward and fused modes, the last
with its split-batch form) against the JAX kernel.

On the CPU the port's wrapper runs its plain version; it is held against
the Pallas kernel in interpret mode (``repro.kernels.ops.vfl_grad``) and
against ``repro.kernels.ref.vfl_grad_ref`` at the bounds of
``tests/test_kernels.py``: z at atol = rtol = 1e-4, g at atol 1e-5 /
rtol 1e-4.  The CUDA kernel itself runs only on a card: its tests are
marked ``cuda`` and skip here.  JAX is imported
inside fixtures, so the file also runs where only the port is installed:
``python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py``.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import vfl_grad as vg

TOL = dict(atol=1e-4, rtol=1e-4)
GTOL = dict(atol=1e-5, rtol=1e-4)
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


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,d,m,lam,denom", [
    (32, 512, None, None, None),   # SGD step: ϑ against every feature
    (32, 512, 2, None, None),      # SVRG step: iterate and snapshot, M = 2
    (37, 7, 1, None, 1),           # SAGA step: XᵀΔϑ, denom 1, odd block
    (100, 200, 3, 0.03, None),     # ragged B and D, with the λW epilogue
    (2500, 130, None, 0.03, 1000),  # several row chunks on the card
    (64, 33, 2, None, 1000),
])
def test_backward_matches_jax(jnp, jops, dtype, b, d, m, lam, denom):
    x_np = _rand(11, (b, d))
    th_np = _rand(12, (b,) if m is None else (b, m))
    xt, xj = _pair(jnp, x_np, dtype)
    wt = wj = None
    if lam is not None:
        wt, wj = _pair(jnp, _rand(13, (d,) if m is None else (d, m)), dtype)
    lam = lam or 0.0
    z, g = ops.vfl_grad(xt, wt, torch.from_numpy(th_np), lam,
                        mode="backward", denom=denom)
    zj, gj = jops.vfl_grad(xj, wj, jnp.asarray(th_np), lam, mode="backward",
                           denom=denom, interpret=True)
    assert z is None and zj is None
    assert g.dtype == torch.float32
    assert tuple(g.shape) == tuple(gj.shape) == \
        ((d,) if m is None else (d, m))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), **GTOL)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("m,lam", [(None, 0.0), (2, 0.0), (3, 0.03)])
def test_backward_party_axis_matches_per_party_jax(jnp, jops, shared, m,
                                                   lam):
    """One call over a leading party axis equals the reference's kernel
    run party by party; a shared ϑ is an ``expand`` view of one ϑ."""
    p, b, d = 3, 37, 100
    x_np = _rand(14, (p, b, d))
    tail = () if m is None else (m,)
    th_np = _rand(15, (b,) + tail if shared else (p, b) + tail)
    w_np = _rand(16, (p, d) + tail) if lam else None
    th = torch.from_numpy(th_np)
    th = th.expand(p, *th.shape) if shared else th
    _, g = ops.vfl_grad(torch.from_numpy(x_np),
                        None if w_np is None else torch.from_numpy(w_np),
                        th, lam, mode="backward")
    assert tuple(g.shape) == (p, d) + tail
    for i in range(p):
        _, gj = jops.vfl_grad(
            jnp.asarray(x_np[i]),
            None if w_np is None else jnp.asarray(w_np[i]),
            jnp.asarray(th_np if shared else th_np[i]), lam,
            mode="backward", interpret=True)
        np.testing.assert_allclose(g[i].numpy(), np.asarray(gj), **GTOL)


@pytest.mark.parametrize("m", [None, 3])
def test_backward_ref_matches_jax_ref(jnp, jref, m):
    b, d = 40, 24
    x = _rand(17, (b, d))
    w = _rand(18, (d,) if m is None else (d, m))
    th = _rand(19, (b,) if m is None else (b, m))
    g = ref.vfl_backward_ref(torch.from_numpy(x), torch.from_numpy(th),
                             torch.from_numpy(w), 0.01, denom=7)
    _, gj = jref.vfl_grad_ref(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(th), 0.01, denom=7)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), **GTOL)


def test_backward_mode_is_ported():
    """``mode="backward"`` returns ``(None, g)`` on every device (it
    raised ``NotImplementedError`` before this mode was ported)."""
    z, g = ops.vfl_grad(torch.ones((16, 8)), None, torch.ones(16),
                        mode="backward")
    assert z is None
    torch.testing.assert_close(g, torch.ones(8))


@pytest.mark.parametrize("split", [None, 8], ids=["fused", "fused-split"])
def test_fused_mode_is_ported(split):
    """``mode="fused"`` returns ``(z, g)`` on every device, with and
    without ``split`` (both raised ``NotImplementedError`` before this
    mode was ported)."""
    nb = 16 if split is None else split
    z, g = ops.vfl_grad(torch.ones((16, 8)), torch.ones(8), torch.ones(nb),
                        mode="fused", split=split)
    torch.testing.assert_close(z, torch.full((16 - (split or 0),), 8.0))
    torch.testing.assert_close(g, torch.ones(8))


@pytest.mark.parametrize("b,d,m", [
    (128, 256, 1),      # tile-divisible
    (100, 130, 1),      # ragged on both axes
    (96, 384, 3),       # multi-dominator rank
    (100, 70, 3),       # ragged + M = 3
])
def test_fused_equals_separate_calls(jnp, jops, b, d, m):
    """The fused mode gives the forward-only z and the backward-only g of
    two separate calls (1e-6, as ``tests/test_kernels.py``), and matches
    the JAX kernel's fused mode."""
    x = torch.from_numpy(_rand(21, (b, d)))
    w = torch.from_numpy(_rand(22, (d, m)))
    th = torch.from_numpy(_rand(23, (b, m)))
    zf, gf = ops.vfl_grad(x, w, th, 0.03, mode="fused")
    z1, _ = ops.vfl_grad(x, w, mode="forward")
    _, g1 = ops.vfl_grad(x, w, th, 0.03, mode="backward")
    np.testing.assert_allclose(zf.numpy(), z1.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(gf.numpy(), g1.numpy(), atol=1e-6, rtol=0)
    zj, gj = jops.vfl_grad(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                           jnp.asarray(th.numpy()), 0.03, mode="fused",
                           interpret=True)
    np.testing.assert_allclose(zf.numpy(), np.asarray(zj), **TOL)
    np.testing.assert_allclose(gf.numpy(), np.asarray(gj), **GTOL)


SPLITS = [
    (64, 64, 128, 1, 1),     # symmetric sides
    (60, 40, 70, 1, 3),      # ragged rows, distinct side column counts
    (32, 96, 130, 2, 2),     # asymmetric row blocks, SVRG rank
    (100, 100, 96, 1, 4),
]


@pytest.mark.parametrize("bb,bf,d,mw,mth", SPLITS)
def test_split_matches_jax(jnp, jops, bb, bf, d, mw, mth):
    """The split-batch form (the pipelined step): rows [0, bb) against θ,
    rows [bb, bb+bf) against w, as the JAX kernel computes it."""
    x = _rand(24, (bb + bf, d))
    w = _rand(25, (d, mw))
    th = _rand(26, (bb, mth))
    z, g = ops.vfl_grad(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(th), mode="fused", split=bb,
                        denom=bb)
    zj, gj = jops.vfl_grad(jnp.asarray(x), jnp.asarray(w), jnp.asarray(th),
                           0.0, mode="fused", split=bb, denom=bb,
                           interpret=True)
    assert tuple(z.shape) == tuple(zj.shape) == (bf, mw)
    assert tuple(g.shape) == tuple(gj.shape) == (d, mth)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), **GTOL)


def test_split_rank1_matches_jax(jnp, jops):
    """Rank-1 sides squeeze independently; denom defaults to the
    backward rows."""
    x, w, th = _rand(27, (96, 50)), _rand(28, (50,)), _rand(29, (64,))
    z, g = ops.vfl_grad(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(th), mode="fused", split=64)
    zj, gj = jops.vfl_grad(jnp.asarray(x), jnp.asarray(w), jnp.asarray(th),
                           mode="fused", split=64, interpret=True)
    assert tuple(z.shape) == (32,) and tuple(g.shape) == (50,)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), **GTOL)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("mw,mth,lam,denom", [(None, None, 0.0, None),
                                              (1, 2, 0.0, None),
                                              (2, 2, 0.03, 1)])
def test_split_party_axis_matches_per_party_jax(jnp, jops, shared, mw, mth,
                                                lam, denom):
    """One call over a leading party axis equals the JAX kernel run party
    by party: θ shared (an ``expand`` view, party stride 0) or per party
    (pipelined SAGA's per-party Δϑ with denom 1)."""
    p, bb, bf, d = 3, 37, 29, 100
    x_np = _rand(30, (p, bb + bf, d))
    w_np = _rand(31, (p, d) if mw is None else (p, d, mw))
    tail = () if mth is None else (mth,)
    th_np = _rand(32, (bb,) + tail if shared else (p, bb) + tail)
    th = torch.from_numpy(th_np)
    th = th.expand(p, *th.shape) if shared else th
    z, g = ops.vfl_grad(torch.from_numpy(x_np), torch.from_numpy(w_np), th,
                        lam, mode="fused", split=bb, denom=denom)
    assert tuple(z.shape) == (p, bf) + (() if mw is None else (mw,))
    assert tuple(g.shape) == (p, d) + tail
    for i in range(p):
        zj, gj = jops.vfl_grad(
            jnp.asarray(x_np[i]), jnp.asarray(w_np[i]),
            jnp.asarray(th_np if shared else th_np[i]), lam, mode="fused",
            split=bb, denom=denom, interpret=True)
        np.testing.assert_allclose(z[i].numpy(), np.asarray(zj), **TOL)
        np.testing.assert_allclose(g[i].numpy(), np.asarray(gj), **GTOL)


@pytest.mark.parametrize("xs,ws,ths,lam,kw", [
    ((16, 8), (8,), (16,), 0.0, dict(mode="forward", split=8)),
    ((16, 8), (8,), (16,), 0.0, dict(mode="backward", split=8)),
    ((16, 8), (8,), (16,), 0.0, dict(split=0)),       # split outside (0, B)
    ((16, 8), (8,), (16,), 0.0, dict(split=16)),
    ((16, 8), (8,), (16,), 0.0, dict(split=8)),       # θ rows != split
    ((16, 8), (8, 2), (16, 3), 0.0, {}),              # no split: Mw != Mθ
    ((16, 8), (8, 1), (8, 3), 0.1, dict(split=8)),    # λw with Mw != Mθ
    ((16, 8), (9,), (8,), 0.0, dict(split=8)),        # w rows != D
    ((3, 16, 8), (2, 8), (3, 8), 0.0, dict(split=8)),  # party counts
    ((3, 16, 8), (8,), (3, 8), 0.0, dict(split=8)),   # w needs the party axis
])
def test_fused_bad_operands_raise(xs, ws, ths, lam, kw):
    kw = {"mode": "fused", **kw}
    with pytest.raises(ValueError):
        ops.vfl_grad(torch.ones(xs), torch.ones(ws), torch.ones(ths), lam,
                     **kw)


@pytest.mark.parametrize("xs,ths,ws,lam", [
    ((16, 8), (16,), None, 0.1),            # λW without w
    ((16, 8), (15,), None, 0.0),            # θ rows != B
    ((16, 8), (16, 2), (8, 3), 0.1),        # w and θ column counts differ
    ((16, 8), (16, 2), (9, 2), 0.1),        # w rows != D
    ((3, 16, 8), (2, 16), None, 0.0),       # party count mismatch
    ((3, 16, 8), (3, 16), (3, 8, 1), 0.1),  # w rank != θ rank
])
def test_backward_bad_operands_raise(xs, ths, ws, lam):
    with pytest.raises(ValueError):
        ops.vfl_grad(torch.ones(xs), None if ws is None else torch.ones(ws),
                     torch.ones(ths), lam, mode="backward")


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
    ops.vfl_grad(torch.ones((3, 4, 8)), None, torch.ones((3, 4)),
                 mode="backward")
    ops.vfl_grad(torch.ones((3, 4000, 8)), None,
                 torch.ones(4000).expand(3, 4000), mode="backward")
    ops.vfl_grad(torch.ones((3, 8, 8)), torch.ones((3, 8)),
                 torch.ones((3, 4, 2)), mode="fused", split=4)
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
                                   (3, 37, 333, 21),
                                   # the narrow body: M = 1..4, D off the
                                   # vector width and below a warp, more
                                   # than one pass, the streaming geometry
                                   (8, 32, 512, 2), (8, 64, 512, 3),
                                   (8, 64, 512, 4), (3, 37, 333, 1),
                                   (3, 37, 333, 3), (2, 19, 33, 2),
                                   (2, 19, 70, 1), (2, 9, 20, 4),
                                   (2, 9, 7, 1), (1, 5, 1030, 2),
                                   (8, 4096, 512, 0), (2, 3000, 40, 3)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (8, 32, 512, 0, True, False),    # SGD step, ϑ shared by the parties
    (8, 32, 512, 2, True, False),    # SVRG step
    (8, 32, 512, 0, False, False),   # SAGA step, per-party Δϑ
    (5, 37, 333, 3, False, True),    # ragged, λW
    (3, 2500, 130, 5, True, True),   # several chunks, wide M
    (1, 3001, 77, 2, False, True),
    (2, 7, 40, 0, True, False),      # fewer rows than a block's 8 warps
    (3, 13, 33, 1, False, True),     # B and D off the warp and tile sizes
    (2, 1024, 64, 0, True, False),   # exactly one chunk
    (2, 1025, 70, 2, False, True),   # a one-row second chunk
    (2, 50, 45, 5, True, True),      # M = 5: two theta-column groups
    (1, 40, 20, 33, False, False)])  # M = 33: nine groups
def test_cuda_backward_matches_plain(cuda_device, dtype, shape):
    p, b, d, m, shared, with_w = shape
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    tail = () if m == 0 else (m,)
    x = torch.randn((p, b, d), generator=gen, device=cuda_device).to(dtype)
    th = torch.randn((b,) + tail if shared else (p, b) + tail,
                     generator=gen, device=cuda_device)
    th = th.expand(p, *th.shape) if shared else th
    w = torch.randn((p, d) + tail, generator=gen,
                    device=cuda_device).to(dtype) if with_w else None
    lam = 0.03 if with_w else 0.0
    before = dict(vg.KERNEL.launches)
    _, g = ops.vfl_grad(x, w, th, lam, mode="backward")
    torch.cuda.synchronize()
    multi = b > vg.BWD_CHUNK_ROWS
    assert vg.KERNEL.launches == {
        **before,
        "vfl_backward_rows": before["vfl_backward_rows"] + 1,
        "vfl_backward_reduce": before["vfl_backward_reduce"] + multi}
    torch.testing.assert_close(g, ref.vfl_backward_ref(x, th, w, lam),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # P, Bb, Bf, D, Mw, Mθ, θ shared, λ, denom
    (8, 32, 32, 512, 1, 1, True, 0.0, None),    # pipelined SGD step
    (8, 32, 32, 512, 2, 2, True, 0.0, None),    # pipelined SVRG step
    (8, 64, 64, 512, 1, 2, True, 0.0, 32),      # multi-pipelined, block-diag
    (8, 32, 32, 512, 1, 1, False, 0.0, 1),      # pipelined SAGA, per party
    (3, 60, 40, 70, 1, 3, True, 0.0, None),     # ragged split
    (2, 32, 96, 130, 2, 2, False, 0.03, None),  # λw beside the split
    (2, 13, 11, 40, 32, 32, True, 0.0, None),   # wide forward side
    (2, 13, 11, 40, 37, 6, False, 0.0, None),
    (2, 2500, 7, 33, 1, 3, True, 0.0, None),    # chunked backward side
    (1, 1500, 40, 130, 2, 2, False, 0.03, None),
    (2, 5, 3, 40, 1, 1, True, 0.0, None),       # fewer rows than warps
    (1, 1025, 9, 70, 2, 5, False, 0.0, None),   # a one-row second chunk
    (2, 20, 10, 50, 1, 33, False, 0.0, None)])  # nine theta-column groups
def test_cuda_fused_split_matches_plain(cuda_device, dtype, shape):
    p, bb, bf, d, mw, mth, shared, lam, denom = shape
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((p, bb + bf, d), generator=gen,
                    device=cuda_device).to(dtype)
    w = torch.randn((p, d, mw), generator=gen, device=cuda_device).to(dtype)
    th = torch.randn((bb, mth) if shared else (p, bb, mth), generator=gen,
                     device=cuda_device)
    th = th.expand(p, *th.shape) if shared else th
    before = dict(vg.KERNEL.launches)
    z, g = ops.vfl_grad(x, w, th, lam, mode="fused", split=bb, denom=denom)
    torch.cuda.synchronize()
    assert vg.KERNEL.launches == {
        **before, "vfl_fused_split": before["vfl_fused_split"] + 1,
        "vfl_backward_reduce": before["vfl_backward_reduce"]
        + (bb > vg.BWD_CHUNK_ROWS)}
    zr, gr = ref.vfl_fused_ref(x, w, th, lam, denom, bb)
    torch.testing.assert_close(z, zr, **TOL)
    torch.testing.assert_close(g, gr, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 32, 512, 1), (3, 100, 70, 3),
                                   (2, 37, 40, 33), (1, 1100, 20, 2),
                                   (2, 7, 33, 1), (1, 1025, 40, 5)])
def test_cuda_fused_equals_separate_programs(cuda_device, shape):
    """Without ``split`` the fused program sums every output in the order
    of the single-mode programs: bit for bit the same z and g."""
    p, b, d, m = shape
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((p, b, d), generator=gen, device=cuda_device)
    w = torch.randn((p, d, m), generator=gen, device=cuda_device)
    th = torch.randn((p, b, m), generator=gen, device=cuda_device)
    z, g = ops.vfl_grad(x, w, th, 0.03, mode="fused")
    z1, _ = ops.vfl_grad(x, w, mode="forward")
    _, g1 = ops.vfl_grad(x, w, th, 0.03, mode="backward")
    torch.cuda.synchronize()
    assert torch.equal(z, z1) and torch.equal(g, g1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # P, Bb, Bf (None: the backward mode), D, Mθ
    (8, 32, None, 512, 1),      # the SGD step
    (3, 2500, None, 130, 2),    # several chunks and the reduce
    (2, 2500, 7, 33, 3),        # split form, chunked backward side
    (1, 1025, 40, 70, 5)])
def test_cuda_backward_repeats_bit_for_bit(cuda_device, dtype, shape):
    """No float atomics: two calls sum every output in the same order."""
    p, bb, bf, d, m = shape
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn((p, bb + (bf or 0), d), generator=gen,
                    device=cuda_device).to(dtype)
    w = torch.randn((p, d, m), generator=gen, device=cuda_device).to(dtype)
    th = torch.randn((p, bb, m), generator=gen, device=cuda_device)
    if bf is None:
        first, again = (ops.vfl_grad(x, w, th, 0.03, mode="backward")[1]
                        for _ in range(2))
    else:
        first, again = (torch.cat([t.flatten() for t in ops.vfl_grad(
            x, w, th, 0.03, mode="fused", split=bb)]) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def _forward_operands(device, dtype, p, b, d, m, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((p, b, d), generator=gen, device=device).to(dtype)
    w = torch.randn((p, d, m), generator=gen, device=device).to(dtype)
    return x, w


def _misaligned(t):
    """A contiguous copy of t at a storage offset of one element, so its
    data pointer is off the 16-byte vector width."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,m", [(512, 1), (512, 2), (333, 3), (40, 4),
                                 # the wide program
                                 (512, 5), (32, 16), (512, 32), (333, 33)])
def test_cuda_forward_rows_bit_identical_across_launches(cuda_device, dtype,
                                                         d, m):
    """A row's z depends on D, M and its column alone: the same bits in a
    batch of 1, 4, 32, 64 or 4,096 rows (the narrow program's streaming
    geometry; a wide block's row tile holds the row at another place), in
    a (1, B, D) launch and in a (8, B, D) launch, at any row offset."""
    x, w = _forward_operands(cuda_device, dtype, 8, 4096, d, m, 5)
    full = vg.KERNEL.forward(x, w)
    for rows in (slice(0, 1), slice(0, 4), slice(0, 32), slice(0, 64),
                 slice(1000, 1064), slice(1003, 1007), slice(4095, 4096)):
        part = vg.KERNEL.forward(x[:, rows].contiguous(), w)
        assert torch.equal(part, full[:, rows]), rows
    one = vg.KERNEL.forward(x[3:4].contiguous(), w[3:4].contiguous())
    assert torch.equal(one, full[3:4])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64, 512, 1), (8, 32, 512, 2),
                                   (3, 37, 333, 3), (2, 3000, 64, 1),
                                   (8, 64, 512, 32), (3, 37, 336, 20)])
def test_cuda_forward_misaligned_view_bit_identical(cuda_device, dtype,
                                                    shape):
    """Vector loads (aligned) and element loads (a view whose pointer is
    off 16 bytes) sum every row in one order: the same bits."""
    x, w = _forward_operands(cuda_device, dtype, *shape, 6)
    want = vg.KERNEL.forward(x, w)
    assert torch.equal(vg.KERNEL.forward(_misaligned(x), w), want)
    assert torch.equal(vg.KERNEL.forward(x, _misaligned(w)), want)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # P, Bb, Bf, D, Mw, Mθ
    (8, 32, 32, 512, 1, 1),      # the pipelined SGD step
    (8, 32, 32, 512, 2, 2),      # the pipelined SVRG step
    (8, 64, 64, 512, 1, 2),      # multi-pipelined
    (3, 60, 40, 70, 3, 3),
    (2, 13, 3000, 512, 4, 1),    # a streaming forward side
    (8, 32, 64, 512, 32, 1),     # a wide forward side
    (2, 13, 11, 40, 37, 6)])
def test_cuda_fused_forward_side_equals_forward(cuda_device, dtype, shape):
    """``vfl_fused_split``'s forward blocks run the forward program's body
    (narrow or wide by Mw): its z equals the forward mode's over the same
    rows bit for bit, also from a misaligned x."""
    p, bb, bf, d, mw, mth = shape
    x, w = _forward_operands(cuda_device, dtype, p, bb + bf, d, mw, 7)
    th = torch.randn((p, bb, mth), device=cuda_device)
    z, _ = vg.KERNEL.fused(x, w, th, 0.0, float(bb), bb)
    want = vg.KERNEL.forward(x[:, bb:].contiguous(), w)
    assert torch.equal(z, want)
    zm, _ = vg.KERNEL.fused(_misaligned(x), w, th, 0.0, float(bb), bb)
    assert torch.equal(zm, want)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 64, 512, 1), (8, 4096, 512, 2),
                                   (3, 37, 333, 3)])
def test_cuda_forward_repeats_bit_for_bit(cuda_device, dtype, shape):
    x, w = _forward_operands(cuda_device, dtype, *shape, 8)
    first, again = (vg.KERNEL.forward(x, w) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.parametrize("wrapper,source", [("NARROW_MAX_M", "kNarrow"),
                                            ("BWD_CHUNK_ROWS", "kChunkRows")])
def test_wrapper_constants_match_source(wrapper, source):
    """The wrapper sizes the backward workspace and picks the forward
    program from constants that the CUDA source defines for itself; a
    mismatch would index the workspace out of bounds."""
    text = vg.CudaKernel().source.read_text()
    found = re.findall(rf"constexpr int {source} = (\d+);", text)
    assert found == [str(getattr(vg, wrapper))]
