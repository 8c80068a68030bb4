"""The port's mixture of experts (``models.moe``) and the MoE LM family
(reduced granite-moe-1b-a400m and qwen3-moe-30b-a3b: 2 layers, d_model
128, 4/2 heads of 32, 4 experts top-2 of width 64, vocabulary 512)
against the JAX package.

Parameters come from the reference's ``init_moe`` and ``init_params`` and
cross as numpy arrays (``convert.lm_params`` for the LM).  The reference
runs on one device (its party count 1) and, for ``apply_moe_sharded`` at
q = 2 and 4 and the reduced qwen3-moe at q = 4 under both dispatch modes,
in one subprocess with 4 forced host devices.

Tolerances, with their reasons:

* the router: the selections equal wherever the reference's k-th to
  (k+1)-th probability margin exceeds ``ROUTE_MARGIN`` = 1e-6 (below it a
  1-ulp difference of the f32 logits may swap them), the gates, lb_loss
  and z_loss within 1e-6 (f32 sums of the same softmax);
* ``apply_moe`` and ``apply_moe_sharded``: f32 within 1e-5 (the gate
  sums in another order), bf16 within 2e-2 of the largest reference
  value (``HIDDEN_REL``: the parties' bf16 partials are summed in
  another order); their gradients (router, w_*, x) within 1e-5 of each
  leaf's largest reference value, at cf 8 (nothing drops);
* the LM: the tolerances of ``tests/test_torch_lm.py`` (hidden states
  and caches within ``HIDDEN_REL`` = 2e-2, tokens equal where the top-two
  logit margin exceeds 2⁻⁵ of the largest logit), the loss within
  ``LOSS_TOL`` = 2e-3.  A layer-1 cache row depends on its token's
  layer-0 routing, which bf16 rounding may flip where the router's k-th
  and (k+1)-th probabilities are within ``ROUTE_DECIDED`` = 2⁻⁸ (one such
  token of 128, margin 3e-5, flips between the port and the reference's
  4-device run): those rows are left out, and at least 3/4 of the tokens
  must be decided;
* ``train_loss``'s leaf gradients: with f32 activations (both packages'
  ``ACT_DTYPE`` set to float32, so only the head rounds to bf16) within
  ``F32_GRAD_REL`` = 2e-3 of each leaf's largest reference value and
  2e-4 in relative L2 (measured: at most 7.7e-4 and 7.6e-5); with the
  bf16 activations each leaf within ``BF16_GRAD_L2`` = 0.2 in relative
  L2.  An MoE layer's expert and router gradients move far more than a
  dense layer's under bf16 rounding of its input: the reference's own
  scanned stack and an op-by-op run of the same layer on the same bf16
  values differ by 6.5% in relative L2 on the expert leaves, and one bf16
  ulp on 23% of the port's MoE input moves them by 6.5-8% (up to 28% of
  the largest value), so the bf16 bound is 2.5× that and the f32 check
  carries the comparison.

Tests marked ``cuda`` need the card and skip here.
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
from _hyp import given, settings, st
from test_torch_lm import (HIDDEN_REL, _assert_rel, _assert_tokens,
                           _jax_logits)

from repro_torch import convert
from repro_torch.configs.base import MoESpec, ShapeConfig, get_arch
from repro_torch.configs.inputs import make_batch
from repro_torch.core.secure_agg import mask_generator
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels import vfl_grad as vg
from repro_torch.launch import train as ttrain
from repro_torch.launch.serve import serve
from repro_torch.models import model as tm
from repro_torch.models import moe
from repro_torch.optim.delayed import leaf_delays
from repro_torch.optim.tree import leaves_with_path
from repro_torch.sharding.api import Runtime

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["granite_moe_1b_a400m", "qwen3_moe_30b_a3b"]
QS = [1, 2, 4]
ROUTE_MARGIN = 1e-6
# a token's routing at layer 0 is "decided" where its k-th to (k+1)-th
# router probability margin exceeds 2⁻⁸: bf16 rounding of the layer's input
# moves each logit (|logit| < 1 here) by about 2⁻⁸ of its size at most, and
# a probability by less
ROUTE_DECIDED = 2.0 ** -8
LOSS_TOL = 2e-3
F32_GRAD_REL, F32_GRAD_L2 = 2e-3, 2e-4
BF16_GRAD_L2 = 0.2
PROMPT, STEPS = 8, 8                   # decode: 8 + 8 positions
B, S = 2, 64                           # train_loss's batch


def _rt(q, **kw):
    return Runtime(model_size=q, **kw)


def _gen(seed=0):
    return mask_generator(seed, device="cpu")


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(np.asarray(a, np.float32)))
    return out if dtype is None else out.to(dtype)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(np.asarray(a).astype(np.float32))


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
    from repro.models import moe as jmoe
    from repro.sharding.api import single_device_runtime
    return dict(jax=jax, jnp=jnp, jm=jm, jmoe=jmoe, inputs=jinputs,
                get_arch=jget_arch, Shape=JShape,
                rt=single_device_runtime(attn_chunk=32, loss_chunk=16))


def _layer_case(jx, e, seed=0, d=32, f=64, shape=(2, 16)):
    """The reference's MoE parameters (numpy) and an input (numpy f32)."""
    jax = jx["jax"]
    params = jax.tree.map(np.asarray, jx["jmoe"].init_moe(
        jax.random.PRNGKey(seed), d, f, e))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 100),
                                     shape + (d,)), np.float32)
    return params, x


def _port_params(params, grad=False):
    return {k: _t(v).requires_grad_(grad) for k, v in params.items()}


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("e", [4, 8])
def test_route_matches_jax(jx, e, k):
    jnp = jx["jnp"]
    params, x = _layer_case(jx, e, seed=e + k, shape=(64,))
    sel, gates, aux = jx["jmoe"]._route(jnp.asarray(params["router"]),
                                        jnp.asarray(x), k)
    tsel, tgates, taux = moe._route(_t(params["router"]), _t(x), k)
    probs = np.sort(np.asarray(jx["jax"].nn.softmax(
        x @ params["router"], axis=-1)), axis=-1)[:, ::-1]
    decided = probs[:, k - 1] - (probs[:, k] if k < e else 0) \
        > ROUTE_MARGIN
    assert decided.mean() > 0.9
    assert tsel.dtype == torch.int64 and tsel.shape == (64, k)
    np.testing.assert_array_equal(tsel.numpy()[decided],
                                  np.asarray(sel)[decided])
    np.testing.assert_allclose(tgates.numpy(), np.asarray(gates), atol=1e-6)
    np.testing.assert_allclose(tgates.sum(-1).numpy(), 1.0, atol=1e-6)
    for name in ("lb_loss", "z_loss"):
        assert taux[name].dim() == 0 and taux[name].dtype == torch.float32
        assert abs(float(taux[name]) - float(aux[name])) <= 1e-6, name


def test_route_breaks_ties_to_the_lower_expert():
    """Equal probabilities: the lower expert first, as jax.lax.top_k."""
    router = torch.zeros((4, 6))
    router[:, 5] = 1.0
    sel, gates, _ = moe._route(router, torch.ones((3, 4)), 3)
    assert sel.tolist() == [[5, 0, 1]] * 3


def test_capacity_is_the_reference_expression():
    for cf, k, t, e in [(1.25, 8, 8192, 128), (1.25, 8, 4, 128),
                        (1.25, 2, 64, 4), (8.0, 2, 32, 8), (1.25, 8, 4096,
                                                             32)]:
        assert moe.capacity(cf, k, t, e) == max(8, min(int(cf * k * t / e),
                                                       t))
    assert moe.capacity(1.25, 8, 8192, 128) == 640


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("e", [4, 8])
def test_apply_moe_matches_jax(jx, e, k, cf, dtype):
    jnp = jx["jnp"]
    params, x = _layer_case(jx, e, seed=3 * e + k)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want, waux = jx["jmoe"].apply_moe(
        jx["jax"].tree.map(jnp.asarray, params),
        jnp.asarray(x).astype(jd), top_k=k, capacity_factor=cf)
    got, aux = moe.apply_moe(_port_params(params), _t(x, td), top_k=k,
                             capacity_factor=cf)
    assert got.dtype == td and got.shape == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    else:
        _assert_rel(got, want, HIDDEN_REL)
    for name in aux:
        assert abs(float(aux[name]) - float(waux[name])) <= 1e-6, name


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("e", [4, 8])
def test_apply_moe_grads_match_jax(jx, e, k):
    """Autograd against ``jax.grad`` of Σ out·c + lb_loss + z_loss at
    cf 8: the router, the experts' weights and x."""
    jax, jnp = jx["jax"], jx["jnp"]
    params, x = _layer_case(jx, e, seed=5 * e + k)
    c = np.random.default_rng(e + k).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, x):
        out, aux = jx["jmoe"].apply_moe(p, x, top_k=k, capacity_factor=8.0)
        return jnp.sum(out * c) + aux["lb_loss"] + aux["z_loss"]
    wp, wx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp, tx = _port_params(params, grad=True), _t(x).requires_grad_()
    out, aux = moe.apply_moe(tp, tx, top_k=k, capacity_factor=8.0)
    ((out * _t(c)).sum() + aux["lb_loss"] + aux["z_loss"]).backward()
    for name, g in list(tp.items()) + [("x", tx)]:
        want = np.asarray(wx if name == "x" else wp[name])
        assert np.abs(want).max() > 0, name
        _assert_rel(g.grad, want, 1e-5)


def test_moe_dispatch_validated():
    params = moe.init_moe(torch.Generator().manual_seed(0), 8, 8, 6)
    x = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="parties"):
        moe.apply_moe_sharded(_rt(4), params, x, top_k=2)
    with pytest.raises(ValueError, match="dispatch"):
        moe.apply_moe_sharded(_rt(2), params, x, top_k=2, dispatch="ring")
    with pytest.raises(ValueError, match="moe_dispatch"):
        _rt(2, moe_dispatch="ring")


def test_init_moe_shapes():
    p = moe.init_moe(torch.Generator().manual_seed(0), 16, 24, 4,
                     lead=(3,))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (3, 16, 4), "w_gate": (3, 4, 16, 24),
        "w_up": (3, 4, 16, 24), "w_down": (3, 4, 24, 16)}
    assert all(v.dtype == torch.float32 for v in p.values())
    assert 0.015 < float(p["w_up"].std()) < 0.025


# ---------------------------------------------------------------------------
# the reference's MoE properties (tests/test_properties.py), on the port
# ---------------------------------------------------------------------------

@given(seed=st.integers(0, 200), e=st.sampled_from([4, 8]),
       k=st.sampled_from([1, 2]))
@settings(max_examples=15, deadline=None)
def test_moe_gate_normalization_and_conservation(seed, e, k):
    """Zero input gives zero output, the gates are a convex combination
    and the load-balance term is finite."""
    gen = torch.Generator().manual_seed(seed)
    params = moe.init_moe(gen, 16, 16, e)
    out, aux = moe.apply_moe(params, torch.zeros((2, 8, 16)), top_k=k,
                             capacity_factor=4.0)
    assert torch.equal(out, torch.zeros_like(out))
    assert np.isfinite(float(aux["lb_loss"]))
    x = torch.randn((2, 8, 16), generator=gen)
    _, gates, _ = moe._route(params["router"], x.view(-1, 16), k)
    assert (gates >= 0).all()
    torch.testing.assert_close(gates.sum(-1), torch.ones(16))


@given(seed=st.integers(0, 100))
@settings(max_examples=10, deadline=None)
def test_moe_capacity_monotone(seed):
    """Outputs at cf 8 equal outputs at cf 16 (no drops in either)."""
    gen = torch.Generator().manual_seed(seed)
    params = moe.init_moe(gen, 16, 32, 4)
    x = torch.randn((2, 16, 16), generator=gen)
    o1, _ = moe.apply_moe(params, x, top_k=2, capacity_factor=8.0)
    o2, _ = moe.apply_moe(params, x, top_k=2, capacity_factor=16.0)
    torch.testing.assert_close(o1, o2, atol=1e-6, rtol=0)


@pytest.mark.parametrize("q,dispatch", [(1, "replicated"), (4, "replicated"),
                                        (4, "alltoall")])
def test_moe_token_permutation_equivariance(q, dispatch):
    """Dispatch is per token: permuting the tokens permutes the outputs
    (under ``alltoall`` within a party's token slice)."""
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe(gen, 16, 32, 4)
    x = torch.randn((1, 16, 16), generator=gen)
    rng = np.random.default_rng(0)
    if dispatch == "alltoall":          # within each 4-token slice
        perm = torch.from_numpy(np.concatenate(
            [4 * i + rng.permutation(4) for i in range(4)]))
    else:
        perm = torch.from_numpy(rng.permutation(16))

    def run(x):
        if q == 1:
            return moe.apply_moe(params, x, top_k=2, capacity_factor=8.0)
        return moe.apply_moe_sharded(_rt(q), params, x, top_k=2,
                                     capacity_factor=8.0, dispatch=dispatch)
    o, _ = run(x)
    o_p, _ = run(x[:, perm])
    torch.testing.assert_close(o[:, perm], o_p, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# apply_moe_sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q", QS)
def test_replicated_matches_apply_moe(jx, q, dtype):
    """Under ``replicated`` every q gives the one-party layer (the
    reference's own multi-device check, at cf 1.25 as well as 8): the same
    routing, capacity and aux; only the bf16 party sum may round."""
    params, x = _layer_case(jx, 8, seed=11)
    td = getattr(torch, dtype)
    for cf in (1.25, 8.0):
        want, waux = moe.apply_moe(_port_params(params), _t(x, td),
                                   top_k=2, capacity_factor=cf)
        got, aux = moe.apply_moe_sharded(_rt(q), _port_params(params),
                                         _t(x, td), top_k=2,
                                         capacity_factor=cf)
        assert got.dtype == td
        if dtype == "float32":
            torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
        else:
            _assert_rel(got, want, HIDDEN_REL)
        for name in aux:
            assert float(aux[name]) == float(waux[name])


def test_alltoall_falls_back_to_replicated():
    """Where T does not split into q slices (a decode step at batch 3 over
    q = 2) or q = 1, ``alltoall`` is ``replicated``, as in the
    reference."""
    gen = torch.Generator().manual_seed(1)
    params = moe.init_moe(gen, 16, 32, 8)
    for q, shape in ((2, (3, 1, 16)), (1, (2, 4, 16))):
        x = torch.randn(shape, generator=gen)
        a = moe.apply_moe_sharded(_rt(q), params, x, top_k=2,
                                  dispatch="alltoall")
        r = moe.apply_moe_sharded(_rt(q), params, x, top_k=2,
                                  dispatch="replicated")
        assert torch.equal(a[0], r[0])
        assert all(torch.equal(a[1][k], r[1][k]) for k in a[1])


def test_alltoall_aux_is_party_zero_slice():
    """ROADMAP C.R5: under ``alltoall`` the aux terms are the router's on
    party 0's token slice alone; the output is the one-party layer's where
    nothing drops."""
    gen = torch.Generator().manual_seed(2)
    params = moe.init_moe(gen, 16, 32, 8)
    x = torch.randn((2, 16, 16), generator=gen)
    out, aux = moe.apply_moe_sharded(_rt(4), params, x, top_k=2,
                                     capacity_factor=8.0,
                                     dispatch="alltoall")
    _, _, slice0 = moe._route(params["router"], x.reshape(-1, 16)[:8], 2)
    _, _, whole = moe._route(params["router"], x.reshape(-1, 16), 2)
    for k in aux:
        assert float(aux[k]) == float(slice0[k]) != float(whole[k])
    want, _ = moe.apply_moe(params, x, top_k=2, capacity_factor=8.0)
    torch.testing.assert_close(out, want, atol=1e-6, rtol=0)


SHARDED_CASES = [(q, disp, cf, dt) for q in (2, 4)
                 for disp in ("replicated", "alltoall")
                 for cf in (1.25, 8.0) for dt in ("float32", "bfloat16")]


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def jax_q4(jx, tmp_path_factory):
    """The reference on 4 forced host devices: ``apply_moe_sharded`` at
    q = 2 and 4 (a mesh of q model devices, no data axis) in both modes,
    and the reduced qwen3-moe's prefill and ``train_loss`` at q = 4 under
    each dispatch mode."""
    jax = jx["jax"]
    tmp = tmp_path_factory.mktemp("moe_q4")
    params, x = _layer_case(jx, 8, seed=21, shape=(4, 16))
    cfg = jx["get_arch"]("qwen3_moe_30b_a3b").reduced()
    lm = jax.tree.map(np.asarray, jx["jm"].init_params(
        cfg, jax.random.PRNGKey(0)))
    batch = jx["inputs"].make_batch(cfg, jx["Shape"]("t", S, B, "train"),
                                    jx["rt"], seed=3)
    np.savez(tmp / "in.npz", x=x, tokens=np.asarray(batch["tokens"]),
             labels=np.asarray(batch["labels"]),
             **{"p/" + k: v for k, v in params.items()},
             **{"lm/" + "/".join(p): v for p, v in _flatten(lm)})
    script = textwrap.dedent(f"""
        import dataclasses
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs.base import get_arch
        from repro.launch.mesh import make_mesh_for
        from repro.models import model as jm
        from repro.models import moe as jmoe
        from repro.sharding.api import Runtime, use_runtime
        d = np.load({str(tmp / "in.npz")!r})
        p = {{k[2:]: jnp.asarray(d[k]) for k in d.files
              if k.startswith("p/")}}
        lm = {{}}
        for k in d.files:
            if k.startswith("lm/"):
                node, parts = lm, k[3:].split("/")
                for part in parts[:-1]:
                    node = node.setdefault(part, {{}})
                node[parts[-1]] = jnp.asarray(d[k])
        out = {{}}
        for q in (2, 4):
            rt = Runtime(mesh=make_mesh_for(q, q), batch_axes=("data",),
                         attn_chunk=32, loss_chunk=16)
            for disp in ("replicated", "alltoall"):
                for cf in (1.25, 8.0):
                    for dt in ("float32", "bfloat16"):
                        x = jnp.asarray(d["x"]).astype(getattr(jnp, dt))
                        with use_runtime(rt):
                            o, aux = jax.jit(
                                lambda p, x: jmoe.apply_moe_sharded(
                                    rt, p, x, top_k=2, capacity_factor=cf,
                                    dispatch=disp))(p, x)
                        tag = f"{{q}}_{{disp}}_{{cf}}_{{dt}}"
                        out["out_" + tag] = np.asarray(
                            o.astype(jnp.float32))
                        out["lb_" + tag] = np.asarray(aux["lb_loss"])
                        out["z_" + tag] = np.asarray(aux["z_loss"])
        cfg = get_arch("qwen3_moe_30b_a3b").reduced()
        batch = {{"tokens": jnp.asarray(d["tokens"]),
                  "labels": jnp.asarray(d["labels"])}}
        for disp in ("replicated", "alltoall"):
            rt = Runtime(mesh=make_mesh_for(4, 4), batch_axes=("data",),
                         attn_chunk=32, loss_chunk=16, moe_dispatch=disp)
            with use_runtime(rt):
                loss = jax.jit(lambda p, b: jm.train_loss(
                    rt, cfg, p, b, jax.random.PRNGKey(1)))(lm, batch)
                tok, kv = jax.jit(lambda p, b: jm.prefill(
                    rt, cfg, p, b, jax.random.PRNGKey(0)))(
                        lm, {{"tokens": batch["tokens"]}})
            out["loss_" + disp] = np.asarray(loss)
            out["tok_" + disp] = np.asarray(tok)
            for k in kv:
                out[f"kv_{{disp}}_{{k}}"] = np.asarray(
                    kv[k].astype(jnp.float32))
        np.savez({str(tmp / "out.npz")!r}, **out)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"), params=params, x=x, lm=lm,
                batch=batch)


@pytest.mark.parametrize("q,dispatch,cf,dtype", SHARDED_CASES)
def test_apply_moe_sharded_matches_jax(jax_q4, q, dispatch, cf, dtype):
    """The port's party dimension against the reference's shard_map over
    q devices, output and aux (under ``alltoall`` party 0's slice's,
    C.R5)."""
    tag = f"{q}_{dispatch}_{cf}_{dtype}"
    td = getattr(torch, dtype)
    got, aux = moe.apply_moe_sharded(
        _rt(q), _port_params(jax_q4["params"]), _t(jax_q4["x"], td),
        top_k=2, capacity_factor=cf, dispatch=dispatch)
    want = jax_q4["out_" + tag]
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    else:
        _assert_rel(got, want, HIDDEN_REL)
    assert abs(float(aux["lb_loss"]) - float(jax_q4["lb_" + tag])) <= 1e-6
    assert abs(float(aux["z_loss"]) - float(jax_q4["z_" + tag])) <= 1e-6
    if dispatch == "alltoall":
        t_q = jax_q4["x"].shape[0] * jax_q4["x"].shape[1] // q
        xs = _t(jax_q4["x"], td).reshape(-1, 32)
        _, _, slice0 = moe._route(_t(jax_q4["params"]["router"]),
                                  xs[:t_q], 2)
        assert float(aux["lb_loss"]) == float(slice0["lb_loss"])


@pytest.mark.parametrize("dispatch", ["replicated", "alltoall"])
def test_qwen3_moe_matches_jax_at_q4(jax_q4, dispatch):
    """The reduced qwen3-moe at q = 4 under each dispatch mode against the
    reference's 4-device run: ``train_loss`` (with the aux terms) and the
    prefill's next tokens and KV cache."""
    cfg = get_arch("qwen3_moe_30b_a3b").reduced()
    params = convert.lm_params(jax_q4["lm"], q=4, device="cpu")
    rt = _rt(4, moe_dispatch=dispatch, attn_chunk=32, loss_chunk=16,
             attn_impl="reference")
    batch = {k: torch.as_tensor(np.array(v), dtype=torch.int64)
             for k, v in jax_q4["batch"].items()}
    with torch.no_grad():
        loss = tm.train_loss(rt, cfg, params, batch, _gen())
        tok, kv = tm.prefill(rt, cfg, params, {"tokens": batch["tokens"]},
                             _gen())
    assert abs(float(loss) - float(jax_q4["loss_" + dispatch])) <= LOSS_TOL
    _assert_cache(kv, {k: jax_q4[f"kv_{dispatch}_{k}"] for k in ("k", "v")},
                  _decided(rt, cfg, params, batch["tokens"]))
    assert tok.shape == (B,)


# ---------------------------------------------------------------------------
# the MoE LM family
# ---------------------------------------------------------------------------

def _jfns(jx, cfg):
    """The reference's jitted ``prefill`` and ``decode_step``, and the
    normed hidden states behind their tokens."""
    jax, jm, rt = jx["jax"], jx["jm"], jx["rt"]

    def layer(tree, i):
        return jax.tree.map(lambda a: a[i], tree)

    def decode_hidden(p, token, cache, pos, key):
        x = jm._embed_tokens(rt, cfg, p, token[:, None], key)[:, 0]
        wins = jm.layer_windows(cfg, cache["k"].shape[2])
        for i in range(cfg.n_layers):
            x, _, _ = jm._block_decode(rt, cfg, "attn_moe",
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
    """arch → the reduced config (port and reference), the reference's
    parameters (numpy and JAX), the port's at each q, a "train" batch and
    the reference's jitted functions; built at first use."""
    built = {}

    def get(arch):
        if arch not in built:
            jax = jx["jax"]
            cfg, jcfg = get_arch(arch).reduced(), \
                jx["get_arch"](arch).reduced()
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            params = jax.tree.map(np.asarray, jx["jm"].init_params(
                jcfg, jax.random.PRNGKey(0)))
            batch = jx["inputs"].make_batch(
                jcfg, jx["Shape"]("t", S, B, "train"), jx["rt"], seed=3)
            built[arch] = dict(
                cfg=cfg, jcfg=jcfg, np=params,
                jax=jax.tree.map(jx["jnp"].asarray, params),
                port={q: convert.lm_params(params, q=q, device="cpu")
                      for q in QS},
                batch={k: np.asarray(v) for k, v in batch.items()},
                fn=_jfns(jx, jcfg))
        return built[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(jx, arch):
    cfg, jcfg = get_arch(arch), jx["get_arch"](arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert tm.layer_kinds(cfg) == ("attn_moe",) * cfg.n_layers
    assert cfg.moe == MoESpec(*dataclasses.astuple(jcfg.moe))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(jx, models, arch):
    """The port's ``init_params`` draws the reference's tree (names,
    shapes, dtypes) and ``lm_params`` carries the reference's across."""
    m = models(arch)
    mine = dict(leaves_with_path(tm.init_params(m["cfg"], 0,
                                                device="cpu")))
    carried = dict(leaves_with_path(m["port"][1]))
    want = {jx["jax"].tree_util.keystr(kp): v for kp, v in
            jx["jax"].tree_util.tree_flatten_with_path(m["np"])[0]}
    assert list(mine) == list(carried) == list(want)
    assert "['stack']['moe']['router']" in want
    for path, w in want.items():
        assert tuple(mine[path].shape) == w.shape
        assert mine[path].dtype == carried[path].dtype == torch.float32
        np.testing.assert_array_equal(carried[path].numpy(), w)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_delays_match_jax(models, arch):
    """The delayed optimiser's md5 delays over the MoE tree's ``keystr``
    paths, the router and experts included, are the reference's."""
    import jax
    from repro.optim.delayed import _leaf_delay as jdelay
    m = models(arch)
    paths = [jax.tree_util.keystr(kp) for kp, _ in
             jax.tree_util.tree_flatten_with_path(m["np"])[0]]
    for tau in (3, 4):
        got = leaf_delays(m["port"][1], tau)
        assert list(got) == paths
        assert got == {path: jdelay(path, tau) for path in paths}
    assert {"['stack']['moe']['router']", "['stack']['moe']['w_down']",
            "['stack']['moe']['w_gate']", "['stack']['moe']['w_up']"} \
        <= set(got)


def _decided(rt, cfg, params, tokens):
    """(B, S) bool: each token's layer-0 routing is decided (its k-th to
    (k+1)-th router probability margin exceeds ``ROUTE_DECIDED``)."""
    from repro_torch.models.layers import rms_norm
    with torch.no_grad():
        x = tm._embed_tokens(rt, cfg, params, tokens, _gen())
        p = tm._layer(params["stack"], 0)
        o, _ = tm._apply_attention(rt, cfg, p["attn"],
                                   rms_norm(x, p["norm1"]), tokens.shape[1])
        h = rms_norm(x + o, p["norm2"])
        probs = torch.softmax(h.float() @ p["moe"]["router"], -1)
    top = probs.sort(-1, descending=True).values
    k = cfg.moe.top_k
    decided = (top[..., k - 1] - top[..., k]) > ROUTE_DECIDED
    assert decided.float().mean() >= 0.75
    return decided.numpy()


def _assert_cache(cache, jcache, decided):
    """Layer 0's cache whole, the later layers' on decided tokens."""
    for k in ("k", "v"):
        got, want = _np(cache[k]), _np(jcache[k])
        _assert_rel(got[:1], want[:1], HIDDEN_REL)
        _assert_rel(got[1:][:, decided], want[1:][:, decided], HIDDEN_REL)


def _prompt(jx, m, b=4, s=PROMPT, seed=0):
    shape = ShapeConfig("t", s, b, "prefill")
    got = make_batch(m["cfg"], shape, _rt(1), seed=seed, device="cpu")
    want = jx["inputs"].make_batch(m["jcfg"], shape, jx["rt"], seed=seed)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    return got, want


@pytest.mark.parametrize("secure", [False, True])
@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(jx, models, arch, q, secure):
    """The next tokens wherever the reference's margin decides them, and
    the bf16 KV cache (L, B, S, Hkv, dh)."""
    m = models(arch)
    key = jx["jax"].random.PRNGKey(0)
    tb, jb = _prompt(jx, m, s=16)
    want, jcache = m["fn"]["prefill"](m["jax"], jb, key)
    rt = _rt(q, secure_embed=secure)
    got, cache = tm.prefill(rt, m["cfg"], m["port"][q], tb, _gen())
    cfg = m["cfg"]
    for k in ("k", "v"):
        assert cache[k].dtype == torch.bfloat16
        assert tuple(cache[k].shape) == jcache[k].shape == (
            cfg.n_layers, 4, 16, cfg.n_kv, cfg.head_dim)
    _assert_cache(cache, jcache, _decided(rt, cfg, m["port"][q],
                                          tb["tokens"]))
    h = m["fn"]["last_hidden"](m["jax"], jb["tokens"], key)
    _assert_tokens(got.numpy(), np.asarray(want),
                   _jax_logits(jx, m["jax"]["embed"], h))


def _cache_t(jcache, jnp):
    return {k: torch.from_numpy(np.array(v.astype(jnp.float32)))
            .to(torch.bfloat16) for k, v in jcache.items()}


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(jx, models, arch, q):
    """Eight teacher-forced decode steps after the reference's prefill
    (its cache re-homed into PROMPT + STEPS positions, as
    ``repro/launch/serve.py`` does); each step starts from the reference's
    cache, and the new cache and the tokens must match (an MoE layer at
    decode routes B = 4 tokens with capacity 8, so nothing drops)."""
    jax, jnp = jx["jax"], jx["jnp"]
    m = models(arch)
    _, jb = _prompt(jx, m)
    _, kv = m["fn"]["prefill"](m["jax"], jb, jax.random.PRNGKey(0))
    jcache = jx["jm"].init_cache(jx["rt"], m["jcfg"], 4, PROMPT + STEPS)
    jcache = {k: jax.lax.dynamic_update_slice_in_dim(jcache[k], kv[k], 0,
                                                     axis=2) for k in jcache}
    teacher = np.random.default_rng(1).integers(0, m["cfg"].vocab,
                                                (4, STEPS))
    logits, want_tok, got_tok = [], [], []
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
        assert nxt is cache
        for k in ("k", "v"):
            _assert_rel(nxt[k], jnext[k], HIDDEN_REL)
        hj = m["fn"]["decode_hidden"](m["jax"], token, jcache,
                                      jnp.asarray(pos, jnp.int32), key)
        logits.append(_jax_logits(jx, m["jax"]["embed"], hj))
        want_tok.append(np.asarray(want))
        got_tok.append(got.numpy())
        jcache = jnext
    _assert_tokens(np.stack(got_tok), np.stack(want_tok), np.stack(logits))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(models, arch):
    """The port's own consistency: greedy tokens of the full forward at
    every position against teacher-forced decode from an empty cache, in
    at least 95% of the positions (cf 8, so that the forward's capacity
    drops nothing that a decode step would keep)."""
    m = models(arch)
    cfg = dataclasses.replace(m["cfg"], moe=dataclasses.replace(
        m["cfg"].moe, capacity_factor=8.0))
    params, rt = m["port"][2], _rt(2)
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


@pytest.fixture(scope="module")
def jgrads(jx, models):
    """The reference's (loss, {key path: gradient}) per (arch, secure,
    activation dtype)."""
    jax, jnp, jm = jx["jax"], jx["jnp"], jx["jm"]
    cache = {}

    def get(arch, secure, act):
        if (arch, secure, act) not in cache:
            m = models(arch)
            rt = dataclasses.replace(jx["rt"], secure_embed=secure)
            batch = {k: jnp.asarray(v) for k, v in m["batch"].items()}
            saved = jm.ACT_DTYPE
            jm.ACT_DTYPE = getattr(jnp, act)
            try:
                loss, g = jax.jit(jax.value_and_grad(
                    lambda p: jm.train_loss(rt, m["jcfg"], p, batch,
                                            jax.random.PRNGKey(1))))(
                    m["jax"])
            finally:
                jm.ACT_DTYPE = saved
            cache[arch, secure, act] = (float(loss), {
                jax.tree_util.keystr(kp): np.asarray(v)
                for kp, v in jax.tree_util.tree_flatten_with_path(g)[0]})
        return cache[arch, secure, act]
    return get


def _train_rt(q, **kw):
    return _rt(q, attn_chunk=32, loss_chunk=16, scan_impl="reference",
               attn_impl="reference", **kw)


def _tbatch(m):
    return {k: torch.as_tensor(np.array(v), dtype=torch.int64)
            for k, v in m["batch"].items()}


@pytest.mark.parametrize("secure", [False, True])
@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(models, jgrads, arch, q, secure):
    """The loss (with the router's weighted lb_loss and z_loss) and every
    leaf's gradient against ``jax.value_and_grad`` of the reference's
    ``train_loss``, at bf16 activations."""
    m = models(arch)
    want_loss, want = jgrads(arch, secure, "bfloat16")
    loss, grads = ttrain.loss_and_grads(_train_rt(q, secure_embed=secure),
                                        m["cfg"], m["port"][q], _tbatch(m),
                                        _gen(q))
    assert abs(float(loss) - want_loss) <= LOSS_TOL
    got = dict(leaves_with_path(grads))
    assert list(got) == list(want)
    for path, g in got.items():
        w = want[path]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert torch.isfinite(g).all() and g.abs().max() > 0, path
        assert np.linalg.norm(g.numpy() - w) \
            <= BF16_GRAD_L2 * np.linalg.norm(w), path


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_grads_match_jax_f32(models, jgrads, arch, q, monkeypatch):
    """Every leaf's gradient with f32 activations in both packages (only
    the head rounds to bf16): the comparison the bf16 noise hides."""
    m = models(arch)
    want_loss, want = jgrads(arch, False, "float32")
    monkeypatch.setattr(tm, "ACT_DTYPE", torch.float32)
    loss, grads = ttrain.loss_and_grads(_train_rt(q, secure_embed=False),
                                        m["cfg"], m["port"][q], _tbatch(m),
                                        _gen(q))
    assert abs(float(loss) - want_loss) <= 1e-5
    for path, g in leaves_with_path(grads):
        w = want[path]
        _assert_rel(g, w, F32_GRAD_REL)
        assert np.linalg.norm(g.numpy() - w) \
            <= F32_GRAD_L2 * np.linalg.norm(w), path


def test_train_loss_carries_the_aux_terms(models, monkeypatch):
    """``train_loss`` adds AUX_LOSS_WEIGHT·Σ lb_loss + Z_LOSS_WEIGHT·Σ
    z_loss over the layers, each term positive."""
    m = models("granite_moe_1b_a400m")
    rt, batch = _train_rt(2), _tbatch(m)
    seen = []
    apply = moe.apply_moe_sharded

    def spy(*a, **kw):
        out, aux = apply(*a, **kw)
        seen.append({k: float(v) for k, v in aux.items()})
        return out, aux

    with torch.no_grad():
        base = float(tm.train_loss(rt, m["cfg"], m["port"][2], batch,
                                   _gen()))
        monkeypatch.setattr(tm, "AUX_LOSS_WEIGHT", 0.0)
        monkeypatch.setattr(tm, "Z_LOSS_WEIGHT", 0.0)
        monkeypatch.setattr(tm.moe_lib, "apply_moe_sharded", spy)
        bare = float(tm.train_loss(rt, m["cfg"], m["port"][2], batch,
                                   _gen()))
    assert len(seen) == m["cfg"].n_layers
    assert all(a["lb_loss"] > 0 and a["z_loss"] > 0 for a in seen)
    extra = 0.01 * sum(a["lb_loss"] for a in seen) \
        + 1e-3 * sum(a["z_loss"] for a in seen)
    assert abs(base - bare - extra) <= 1e-5


def test_train_runs_and_lowers_the_loss():
    """``launch.train.train`` on the reduced granite-moe at q = 2 under
    ``vfb2_sgd`` and AdamW: finite losses, AdamW's falling by more than
    0.05 (``examples/train_lm.py``'s threshold)."""
    losses = ttrain.train("granite_moe_1b_a400m", 12, 4, 32, 3e-3,
                          log_every=100, model_parallel=2, device="cpu")
    assert np.isfinite(losses).all()
    assert losses[0] - np.mean(losses[-3:]) > 0.05
    sgd = ttrain.train("qwen3_moe_30b_a3b", 3, 2, 16, 0.3, "vfb2_sgd", 3,
                       log_every=100, model_parallel=4, device="cpu")
    assert len(sgd) == 3 and np.isfinite(sgd).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs(arch):
    """``serve`` at q = 4 on the CPU: ids in range, a finite cache and
    the same tokens from a second call."""
    kw = dict(batch=2, prompt_len=8, gen_tokens=4, model_parallel=4,
              seed=1, device="cpu")
    res = serve(arch, **kw)
    vpad = get_arch(arch).reduced().padded_vocab
    assert res.tokens.shape == (2, 4)
    assert ((res.tokens >= 0) & (res.tokens < vpad)).all()
    assert all(torch.isfinite(v.float()).all() for v in res.cache.values())
    np.testing.assert_array_equal(serve(arch, **kw).tokens, res.tokens)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _per_expert_oracle(params, x, top_k, cf):
    """The plain f32 layer: route, each expert's SwiGLU on its assigned
    rows (the first ``capacity`` in token order), the gate-weighted sum.
    Returns (out f32 (T, D), kept (T,) bool: none of the token's
    assignments dropped)."""
    xt = x.reshape(-1, x.shape[-1]).float()
    t, e = xt.shape[0], params["router"].shape[1]
    probs = torch.softmax(xt @ params["router"].float(), -1)
    gates, sel = torch.topk(probs, top_k, -1)
    gates = gates / gates.sum(-1, keepdim=True)
    cap = moe.capacity(cf, top_k, t, e)
    out = torch.zeros_like(xt)
    kept = torch.ones(t, dtype=torch.bool, device=x.device)
    for j in range(e):
        tok, slot = (sel == j).nonzero(as_tuple=True)
        kept[tok[cap:]] = False
        tok, slot = tok[:cap], slot[:cap]
        h = xt[tok]
        y = (torch.nn.functional.silu(h @ params["w_gate"][j])
             * (h @ params["w_up"][j])) @ params["w_down"][j]
        out.index_add_(0, tok, gates[tok, slot, None] * y)
    return out, kept


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["replicated", "alltoall"])
def test_cuda_moe_layer_against_oracle(cuda_device, dispatch):
    """At a small size on the card: ``apply_moe_sharded`` against the
    plain per-expert f32 oracle on the tokens none of whose assignments
    dropped (within ``HIDDEN_REL`` of the largest value), no host sync
    in the layer, and ``alltoall`` equal to ``replicated`` where nothing
    drops."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = moe.init_moe(gen, 256, 128, 16)
    x = torch.randn((4, 64, 256), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    rt = _rt(4, moe_dispatch=dispatch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe.apply_moe_sharded(rt, params, x, top_k=4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # under alltoall each party's slice of 64 tokens has its own capacity
    slices = x.reshape(4 if dispatch == "alltoall" else 1, -1, 256)
    got = out.reshape(slices.shape).float()
    for xs, gs in zip(slices, got):
        want, kept = _per_expert_oracle(params, xs, 4, 1.25)
        assert kept.float().mean() > 0.5
        err = (gs - want)[kept].abs().max()
        assert float(err) <= HIDDEN_REL * float(want.abs().max())
    assert all(torch.isfinite(v) and v > 0 for v in aux.values())
    wide = {"capacity_factor": 16 / 4, "top_k": 4}
    a, _ = moe.apply_moe_sharded(_rt(4), params, x, dispatch="alltoall",
                                 **wide)
    r, _ = moe.apply_moe_sharded(_rt(4), params, x, dispatch="replicated",
                                 **wide)
    _assert_rel(a.cpu(), r.cpu(), HIDDEN_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_moe_serve_launches(cuda_device, arch):
    """Serving the reduced MoE model on the card launches flash attention
    once per layer of the prefill and decode attention once per layer of
    each decode step, and nothing else."""
    cfg = get_arch(arch).reduced()
    for lib in (vg.KERNEL, ss.KERNEL, fa.KERNEL, da.KERNEL):
        lib.reset_launches()
    res = serve(arch, batch=2, prompt_len=32, gen_tokens=4,
                model_parallel=4, seed=0, device=cuda_device)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches["flash_attention"] == cfg.n_layers
    assert da.KERNEL.launches["decode_attention"] == cfg.n_layers * 3
    assert not any(vg.KERNEL.launches.values())
    assert not any(ss.KERNEL.launches.values())
    assert ((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()
    again = serve(arch, batch=2, prompt_len=32, gen_tokens=4,
                  model_parallel=4, seed=0, device=cuda_device)
    np.testing.assert_array_equal(again.tokens, res.tokens)


@pytest.mark.cuda
def test_cuda_moe_train_step(cuda_device):
    """A training step of the reduced granite-moe on the card: every
    leaf's gradient finite and nonzero, no kernel launched; the no-grad
    kernel-route loss within ``LOSS_TOL`` of the plain route's."""
    cfg = get_arch("granite_moe_1b_a400m").reduced()
    params = tm.init_params(cfg, 0, device=cuda_device)
    batch = make_batch(cfg, ShapeConfig("t", S, B, "train"), _rt(4),
                       device=cuda_device)
    fa.KERNEL.reset_launches()
    loss, grads = ttrain.loss_and_grads(_train_rt(4), cfg, params, batch,
                                        mask_generator(0, device=cuda_device))
    assert not any(fa.KERNEL.launches.values())
    for path, g in leaves_with_path(grads):
        assert torch.isfinite(g).all() and g.abs().max() > 0, path
    with torch.no_grad():
        k = tm.train_loss(_rt(4, attn_chunk=32, loss_chunk=16), cfg, params,
                          batch, mask_generator(0, device=cuda_device))
    assert fa.KERNEL.launches["flash_attention"] == cfg.n_layers
    assert abs(float(k) - float(loss)) <= LOSS_TOL
