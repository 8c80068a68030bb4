"""The port's LM training path against the JAX package: the token stream
and "train" batches, the vocab-parallel loss, ``train_loss`` with every
leaf's gradient, the forward-only rule of the kernel routes, and
``launch.train.train`` (reduced falcon-mamba, gemma3-4b and stablelm:
2 layers, d_model 128, vocabulary 512).

Parameters come from the reference's ``init_params`` and cross with
``convert.lm_params``.  The masks of the secure embedding cannot be the
reference's bits (torch generators), so the two packages agree to the
mask residue.

Tolerances, with their reasons:

* tokens and batches: equal (numpy draws of the same calls);
* the loss: within ``LOSS_TOL`` = 2e-3, the reference's own tolerance for
  its bf16 head (``tests/test_vfl_integration.py:91``);
* the head's gradients (``vocab_parallel_loss``, table and h): within one
  bf16 ulp (2⁻⁷) of the largest reference value: the bf16 cotangents are
  rounded at different places;
* ``train_loss``'s leaf gradients: within ``GRAD_REL`` = 2⁻⁵ (four bf16
  ulps) of each leaf's largest reference value, and within 2⁻⁶ (two
  ulps) in relative L2: the backward runs two bf16 products a matmul in
  every layer, and the frameworks round them at different places
  (measured: at most 1.9e-2 and 1.04e-2);
* ``train``: every loss within ``TRAIN_TOL`` = 1e-2 of the reference's
  over 3 steps: the first within ``LOSS_TOL``; each step's update then
  carries the bf16 rounding of its gradients (AdamW's first step moves
  every weight by lr·sign(g), so a near-zero gradient component rounded
  to the other sign moves by 2·lr).

The reference runs on one device (its party count 1); the port runs at
q = 1 and q = 4 against it.  The loss at q = 4 is also held against the
reference at q = 4, in a subprocess with 4 forced host devices.  The
reference's ``train(optimizer="vfb2_sgd")`` fails under ``jax.jit``
(ROADMAP C.R4: ``tau`` rides in the jitted state), so its trajectory is
built from its own parts, the jitted ``value_and_grad`` of its
``train_loss`` and an eager ``delayed_update``, as its loop would run
them.  Tests marked ``cuda`` need the card and skip here.
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
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.configs.inputs import make_batch
from repro_torch.core.secure_agg import mask_generator
from repro_torch.data.tokens import TokenStream, synthetic_token_batches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as ss
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tm
from repro_torch.optim.tree import leaves_with_path
from repro_torch.sharding.api import Runtime
from repro_torch.vfl.heads import vocab_parallel_loss

REPO = pathlib.Path(__file__).resolve().parents[1]
ULP = 2.0 ** -7                  # one bf16 ulp, relative
LOSS_TOL = 2e-3
GRAD_REL = 2.0 ** -5
TRAIN_TOL = 1e-2
ARCHS = ["falcon_mamba_7b", "gemma3_4b", "stablelm_1_6b"]
B, S = 2, 64                     # train_loss's batch: 4 loss chunks of 16


def _rt(q, **kw):
    kw = dict(dict(attn_chunk=32, loss_chunk=16, scan_impl="reference",
                   attn_impl="reference"), **kw)
    return Runtime(model_size=q, **kw)


def _gen(seed=0):
    return mask_generator(seed, device="cpu")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _assert_rel(got, want, rel, what=""):
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


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
    return dict(jax=jax, jnp=jnp, jm=jm, inputs=jinputs, get_arch=jget_arch,
                Shape=JShape,
                rt=single_device_runtime(attn_chunk=32, loss_chunk=16))


@pytest.fixture(scope="module")
def models(jx):
    """Per architecture: the reduced config, the reference's parameters
    (numpy) and a "train" batch from the reference's ``make_batch``."""
    jax = jx["jax"]
    out = {}
    for arch in ARCHS:
        cfg = get_arch(arch).reduced()
        jcfg = jx["get_arch"](arch).reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        params = jax.tree.map(np.asarray, jx["jm"].init_params(
            jcfg, jax.random.PRNGKey(0)))
        batch = jx["inputs"].make_batch(jcfg, jx["Shape"]("t", S, B, "train"),
                                        jx["rt"], seed=3)
        out[arch] = dict(cfg=cfg, jcfg=jcfg, np=params,
                         batch={k: np.asarray(v) for k, v in batch.items()})
    return out


# ---------------------------------------------------------------------------
# tokens and batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [512, 65024])
def test_token_stream_matches_jax(vocab):
    """Below and above the Zipf alphabet's cap of 32,768 ids."""
    from repro.data.tokens import TokenStream as JStream
    from repro.data.tokens import synthetic_token_batches as jbatches
    got, want = TokenStream(vocab, 5).batches(3, 17), \
        JStream(vocab, 5).batches(3, 17)
    for _ in range(3):
        a, b = next(got), next(want)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(synthetic_token_batches(vocab, 2, 9, 3, seed=1),
                    jbatches(vocab, 2, 9, 3, seed=1), strict=True):
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "gemma3_4b"])
def test_make_train_batch_matches_jax(jx, arch):
    cfg, jcfg = get_arch(arch), jx["get_arch"](arch)
    got = make_batch(cfg, ShapeConfig("t", 11, 3, "train"), _rt(1), seed=7,
                     device="cpu")
    want = jx["inputs"].make_batch(jcfg, jx["Shape"]("t", 11, 3, "train"),
                                   jx["rt"], seed=7)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == torch.int64 and tuple(got[k].shape) == (3, 11)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="mode"):
        make_batch(cfg, ShapeConfig("t", 4, 2, "score"), _rt(1),
                   device="cpu")


# ---------------------------------------------------------------------------
# the vocab-parallel loss
# ---------------------------------------------------------------------------

def _head_case(seed=0, v=512, d=128):
    rng = np.random.default_rng(seed)
    table = (0.5 * rng.standard_normal((v, d))).astype(np.float32)
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    labels = rng.integers(0, v - 12, (B, S))      # the padded rows unused
    return table, h, labels


def _port_loss_grads(q, chunk, table, h, labels):
    tt = torch.from_numpy(table).requires_grad_()
    th = torch.from_numpy(h).requires_grad_()
    loss = vocab_parallel_loss(_rt(q, loss_chunk=chunk), tt, th,
                               torch.from_numpy(labels), table.shape[0])
    gt, gh = torch.autograd.grad(loss, (tt, th))
    return float(loss.detach()), gt, gh


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("q", [1, 4])
def test_vocab_parallel_loss_matches_jax(jx, q, chunk):
    """Loss and ∂/∂table, ∂/∂h against ``jax.value_and_grad`` of the
    reference at q = 1, chunked by ``loss_chunk``."""
    from repro.sharding.api import use_runtime
    from repro.vfl.heads import vocab_parallel_loss as jloss
    jax, jnp = jx["jax"], jx["jnp"]
    table, h, labels = _head_case()
    jrt = dataclasses.replace(jx["rt"], loss_chunk=chunk)
    with use_runtime(jrt):
        want, (wt, wh) = jax.jit(jax.value_and_grad(
            lambda t, x: jloss(jrt, t, x, jnp.asarray(labels, jnp.int32),
                               table.shape[0]), argnums=(0, 1)))(
            jnp.asarray(table), jnp.asarray(h))
    got, gt, gh = _port_loss_grads(q, chunk, table, h, labels)
    assert abs(got - float(want)) <= LOSS_TOL
    _assert_rel(gt, wt, ULP, "table")
    _assert_rel(gh, wh, ULP, "h")


def test_vocab_parallel_loss_equals_plain_ce():
    """The reference's own check (``tests/test_vfl_integration.py:80``):
    the bf16 head within 2e-3 of an f32 cross-entropy."""
    table, h, labels = _head_case(1, v=64, d=16)
    got = vocab_parallel_loss(_rt(4), torch.from_numpy(table),
                              torch.from_numpy(h), torch.from_numpy(labels),
                              64)
    ce = torch.nn.functional.cross_entropy(
        torch.from_numpy(h).reshape(-1, 16) @ torch.from_numpy(table).T,
        torch.from_numpy(labels).reshape(-1))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - float(ce)) <= LOSS_TOL


def test_vocab_parallel_loss_chunk_must_divide():
    table, h, labels = _head_case(2, v=64, d=16)
    with pytest.raises(ValueError, match="loss_chunk"):
        vocab_parallel_loss(_rt(1, loss_chunk=24), torch.from_numpy(table),
                            torch.from_numpy(h), torch.from_numpy(labels), 64)
    with pytest.raises(ValueError, match="party"):
        vocab_parallel_loss(_rt(3), torch.from_numpy(table),
                            torch.from_numpy(h), torch.from_numpy(labels), 64)


def test_vocab_parallel_loss_under_no_grad_equals_grad_mode():
    """The chunks are recomputed in the backward only where autograd
    records them: the value does not depend on it."""
    table, h, labels = _head_case(3)
    args = (torch.from_numpy(table), torch.from_numpy(h),
            torch.from_numpy(labels), 512)
    with torch.no_grad():
        a = vocab_parallel_loss(_rt(4), *args)
    b, _, _ = _port_loss_grads(4, 16, table, h, labels)
    assert float(a) == b


@pytest.fixture(scope="module")
def jax_q4(tmp_path_factory):
    """The reference's loss and its gradients at q = 4: one subprocess
    with 4 forced host devices."""
    tmp = tmp_path_factory.mktemp("jax_q4_loss")
    table, h, labels = _head_case(4)
    np.savez(tmp / "in.npz", table=table, h=h, labels=labels)
    script = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.launch.mesh import make_mesh_for
        from repro.sharding.api import Runtime, use_runtime
        from repro.vfl.heads import vocab_parallel_loss
        d = np.load({str(tmp / "in.npz")!r})
        rt = Runtime(mesh=make_mesh_for(4, 4), batch_axes=("data",),
                     loss_chunk=16)
        y = jnp.asarray(d["labels"], jnp.int32)
        with use_runtime(rt):
            loss, (gt, gh) = jax.jit(jax.value_and_grad(
                lambda t, h: vocab_parallel_loss(rt, t, h, y, 512),
                argnums=(0, 1)))(jnp.asarray(d["table"]), jnp.asarray(d["h"]))
        np.savez({str(tmp / "out.npz")!r}, loss=np.asarray(loss),
                 gt=np.asarray(gt), gh=np.asarray(gh))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"), table=table, h=h, labels=labels)


def test_vocab_parallel_loss_matches_jax_at_q4(jax_q4):
    """q = 4 party blocks in both packages: the reference's shard_map
    over 4 devices (pmax, psum of the blocks' Σexp and label logits)."""
    got, gt, gh = _port_loss_grads(4, 16, jax_q4["table"], jax_q4["h"],
                                   jax_q4["labels"])
    assert abs(got - float(jax_q4["loss"])) <= LOSS_TOL
    _assert_rel(gt, jax_q4["gt"], ULP, "table")
    _assert_rel(gh, jax_q4["gh"], ULP, "h")


# ---------------------------------------------------------------------------
# train_loss and its gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jgrads(jx, models):
    """The reference's (loss, {key path: gradient}) per (arch, secure)."""
    jax, jnp, jm = jx["jax"], jx["jnp"], jx["jm"]
    cache = {}

    def get(arch, secure):
        if (arch, secure) not in cache:
            m = models[arch]
            rt = dataclasses.replace(jx["rt"], secure_embed=secure)
            batch = {k: jnp.asarray(v) for k, v in m["batch"].items()}
            loss, g = jax.jit(jax.value_and_grad(
                lambda p: jm.train_loss(rt, m["jcfg"], p, batch,
                                        jax.random.PRNGKey(1))))(
                jax.tree.map(jnp.asarray, m["np"]))
            cache[arch, secure] = (float(loss), {
                jax.tree_util.keystr(kp): np.asarray(v)
                for kp, v in jax.tree_util.tree_flatten_with_path(g)[0]})
        return cache[arch, secure]

    return get


def _tbatch(m):
    return {k: torch.as_tensor(np.array(v), dtype=torch.int64)
            for k, v in m["batch"].items()}


@pytest.mark.parametrize("secure,q", [(False, 1), (True, 1), (True, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(models, jgrads, arch, secure, q):
    """The loss and every leaf's gradient against ``jax.value_and_grad``
    of the reference's ``train_loss`` (plain scan, plain chunked
    attention, ``attn_chunk=32, loss_chunk=16``)."""
    m = models[arch]
    want_loss, want = jgrads(arch, secure)
    loss, grads = ttrain.loss_and_grads(
        _rt(q, secure_embed=secure), m["cfg"],
        convert.lm_params(m["np"], q=q, device="cpu"), _tbatch(m), _gen(q))
    assert loss.dim() == 0 and not loss.requires_grad
    assert abs(float(loss) - want_loss) <= LOSS_TOL
    got = dict(leaves_with_path(grads))
    assert list(got) == list(want)
    for path, g in got.items():
        w = want[path]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert np.abs(w).max() > 0, path
        _assert_rel(g, w, GRAD_REL, path)
        assert np.linalg.norm(g.numpy() - w) \
            <= 2 * ULP * np.linalg.norm(w), path


def test_train_loss_fills_no_kv_cache(models, monkeypatch):
    """The training forward runs the stack without a KV cache."""
    seen = []
    backbone = tm._backbone

    def spy(*args, **kw):
        seen.append(kw.get("kv"))
        return backbone(*args, **kw)

    monkeypatch.setattr(tm, "_backbone", spy)
    m = models["gemma3_4b"]
    params = convert.lm_params(m["np"], q=1, device="cpu")
    tm.train_loss(_rt(1), m["cfg"], params, _tbatch(m), _gen())
    assert seen == [None]


# ---------------------------------------------------------------------------
# the kernel routes are forward-only
# ---------------------------------------------------------------------------

def _wrapper_calls(device):
    """Each forward-only wrapper with small inputs: (name, inputs,
    call)."""
    g = torch.Generator(device=device).manual_seed(0)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    scan = (rn(2, 8, 16), rn(2, 8, 16).abs() * 0.1, rn(2, 8, 16),
            rn(2, 8, 16), rn(16, 16).abs(), rn(16))
    attn = (rn(1, 4, 8, 32, dtype=torch.bfloat16),
            rn(1, 2, 8, 32, dtype=torch.bfloat16),
            rn(1, 2, 8, 32, dtype=torch.bfloat16))
    dec = (rn(2, 4, 32, dtype=torch.bfloat16),
           rn(2, 8, 2, 32, dtype=torch.bfloat16),
           rn(2, 8, 2, 32, dtype=torch.bfloat16))
    return [("selective_scan", "scan_impl", scan,
             lambda *a: ops.selective_scan(*a)),
            ("flash_attention", "attn_impl", attn,
             lambda *a: ops.flash_attention(*a, causal=True)),
            ("decode_attention", "attn_impl", dec,
             lambda *a: ops.decode_attention(*a, 5, 0, None, shards=2))]


def _check_forward_only(device):
    for name, route, inputs, call in _wrapper_calls(device):
        want = call(*inputs)                     # nothing requires grad
        for i in range(len(inputs)):
            args = [t.clone() for t in inputs]
            args[i].requires_grad_()
            with pytest.raises(RuntimeError,
                               match=f"{name}.*{route}=\"reference\""):
                call(*args)
            with torch.no_grad():
                got = call(*args)
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert not a.requires_grad
                assert torch.equal(a, b)


def test_kernel_wrappers_are_forward_only_on_the_cpu():
    """Under autograd with an input that requires grad each wrapper
    raises (its plain version would differentiate here, its kernel not on
    the card: the rule is the same on both); under no_grad, and with no
    input requiring grad, it runs and gives the same values."""
    _check_forward_only(torch.device("cpu"))


@pytest.mark.parametrize("arch,route", [("falcon_mamba_7b", "scan_impl"),
                                        ("gemma3_4b", "attn_impl")])
def test_train_loss_kernel_route(models, arch, route):
    """Under autograd ``train_loss`` on a kernel route raises; under
    no_grad it runs and agrees with the plain route (on the CPU both
    routes are plain versions: the scan's are one function, the
    attention's the kernel's reference against the chunked form)."""
    m = models[arch]
    params = convert.lm_params(m["np"], q=4, device="cpu")
    kernel = _rt(4, **{route: "kernel"})
    with pytest.raises(RuntimeError, match="reference"):
        ttrain.loss_and_grads(kernel, m["cfg"], params, _tbatch(m), _gen())
    with torch.no_grad():
        got = tm.train_loss(kernel, m["cfg"], params, _tbatch(m), _gen())
        want = tm.train_loss(_rt(4), m["cfg"], params, _tbatch(m), _gen())
    if route == "scan_impl":
        assert float(got) == float(want)
    else:
        assert abs(float(got) - float(want)) <= LOSS_TOL


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------

def _jax_delayed_losses(jx, arch, steps, batch, seq, lr, tau):
    """The reference's ``train(optimizer="vfb2_sgd")`` loop from its own
    parts (its ``train`` cannot jit the delayed state: C.R4)."""
    from repro.data.tokens import synthetic_token_batches as jbatches
    from repro.launch.train import build_runtime
    from repro.optim.delayed import delayed_init, delayed_update
    from repro.sharding.api import use_runtime
    jax, jnp, jm = jx["jax"], jx["jnp"], jx["jm"]
    cfg = jx["get_arch"](arch).reduced()
    rt = build_runtime(1, True)
    key = jax.random.PRNGKey(0)
    losses = []
    with use_runtime(rt):
        params = jm.init_params(cfg, key)
        opt = delayed_init(params, tau)
        vg = jax.jit(jax.value_and_grad(
            lambda p, b, k: jm.train_loss(rt, cfg, p, b, k)))
        for b in jbatches(cfg.vocab, batch, seq, steps):
            key, sub = jax.random.split(key)
            loss, g = vg(params, jax.tree.map(jnp.asarray, b), sub)
            params, opt = delayed_update(params, g, opt, lr=lr)
            losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("optimizer,lr", [("adamw", 1e-3),
                                          ("vfb2_sgd", 0.3)])
@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "gemma3_4b"])
def test_train_matches_jax(jx, models, arch, optimizer, lr, tmp_path,
                           monkeypatch):
    """Three steps of ``train(..., device="cpu")`` from the reference's
    initial parameters (its ``init_params`` patched to give them) track
    ``repro.launch.train.train``'s losses, and the saved checkpoint loads
    in the reference."""
    from repro.checkpoint import load_checkpoint as jload
    from repro.launch.train import train as jtrain
    jax = jx["jax"]
    steps, batch, seq, tau = 3, 2, 32, 3
    if optimizer == "adamw":
        want = jtrain(arch, steps, batch, seq, lr, optimizer, log_every=100)
    else:
        want, _ = _jax_delayed_losses(jx, arch, steps, batch, seq, lr, tau)
    ck = str(tmp_path / "ck")
    monkeypatch.setattr(ttrain.model_lib, "init_params",
                        lambda cfg, seed, device: convert.lm_params(
                            models[arch]["np"], q=1, device=device))
    got = ttrain.train(arch, steps, batch, seq, lr, optimizer, tau,
                       ckpt_dir=ck, log_every=100, device="cpu")
    assert len(got) == len(want) == steps
    assert np.isfinite(got).all()
    assert abs(got[0] - want[0]) <= LOSS_TOL
    np.testing.assert_allclose(got, want, atol=TRAIN_TOL, rtol=0)
    like = {"params": jax.tree.map(np.zeros_like, models[arch]["np"])}
    loaded = jload(ck, like)
    from repro_torch.checkpoint import load_checkpoint
    mine = load_checkpoint(ck, like)
    for (p, a), (_, b) in zip(leaves_with_path(loaded),
                              leaves_with_path(mine)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=p)
        assert np.isfinite(np.asarray(a)).all(), p


def test_train_rejects_unknown_optimizer():
    with pytest.raises(ValueError, match="optimizer"):
        ttrain.train("stablelm_1_6b", 1, 1, 8, 1e-3, "sgd", device="cpu")


def test_train_runs_at_q4_and_lowers_the_loss():
    """The port's own run at q = 4 on the reduced stablelm: the losses
    fall as the reference example demands (``examples/train_lm.py``:
    a drop of more than 0.05)."""
    losses = ttrain.train("stablelm_1_6b", 12, 4, 32, 3e-3, log_every=100,
                          model_parallel=4, device="cpu")
    assert np.isfinite(losses).all()
    assert losses[0] - np.mean(losses[-3:]) > 0.05


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_wrappers_are_forward_only(cuda_device):
    """The same rule on the card: the kernels never hand back an output
    cut from its inputs' graph."""
    _check_forward_only(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kernel,route",
                         [("falcon_mamba_7b", ss, "scan_impl"),
                          ("gemma3_4b", fa, "attn_impl")])
def test_cuda_train_loss_kernel_route(cuda_device, arch, kernel, route):
    """Under no_grad the kernel route's loss launches its kernel once per
    layer and agrees with the plain route's; a training step on the plain
    routes launches none and gives every leaf a finite gradient."""
    cfg = get_arch(arch).reduced()
    params = tm.init_params(cfg, 0, device=cuda_device)
    batch = make_batch(cfg, ShapeConfig("t", S, B, "train"), _rt(4),
                       device=cuda_device)
    with torch.no_grad():
        kernel.KERNEL.reset_launches()
        got = tm.train_loss(_rt(4, **{route: "kernel"}), cfg, params, batch,
                            mask_generator(0, device=cuda_device))
        torch.cuda.synchronize()
        assert sum(kernel.KERNEL.launches.values()) == cfg.n_layers
        want = tm.train_loss(_rt(4), cfg, params, batch,
                             mask_generator(0, device=cuda_device))
    assert abs(float(got) - float(want)) <= LOSS_TOL
    kernel.KERNEL.reset_launches()
    loss, grads = ttrain.loss_and_grads(_rt(4), cfg, params, batch,
                                        mask_generator(0, device=cuda_device))
    torch.cuda.synchronize()
    assert not any(kernel.KERNEL.launches.values())
    assert abs(float(loss) - float(want)) <= LOSS_TOL
    for path, g in leaves_with_path(grads):
        assert torch.isfinite(g).all() and g.abs().max() > 0, path
