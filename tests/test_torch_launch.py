"""The launch tools (``repro_torch.launch.{mesh,hlo_analysis,dryrun}``)
against the JAX package's ``repro.launch`` and against themselves.

* ``SHAPES`` are the reference's; ``param_count``,
  ``active_param_count`` and ``model_flops`` equal the reference's exactly
  for every ``ARCH_IDS`` × ``SHAPES``, full and reduced, ROADMAP C.R9
  included (whisper-tiny's analytic count holds decoder feed-forwards
  that neither package's tree builds).
* The parameters of each full-width tree, built over fake tensors, equal
  ``param_count`` for nine archs; whisper-tiny's fall short by exactly
  the 7,079,424 of C.R9.
* ``make_mesh_for``, ``make_production_mesh`` and ``batch_axes_for`` give
  the reference's axis names and sizes (the reference's in a subprocess
  with 512 forced host devices).
* The memory tracker and the FLOP count of ``launch.dryrun.measure`` on
  real CPU tensors and on fake tensors agree exactly (peak, arguments,
  outputs, aten FLOPs) for ``train_step``, ``prefill`` and
  ``decode_step`` of a dense, an SSM, an MoE and an encoder-decoder
  reduced config on the plain routes; a chain of matmuls gives the peak
  reckoned by hand.
* Each kernel wrapper's fake route returns its plain version's shapes and
  dtypes, runs neither the plain version nor the kernel, and tallies its
  launches and FLOPs; real CPU tensors still take the plain version.
* ``dryrun.main`` over whisper-tiny writes one record per combination it
  runs, each ``ok``, and skips ``long_500k`` as the reference does.
"""
import contextlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import base as tbase
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels import vfl_grad as vg
from repro_torch.launch import dryrun, hlo_analysis, mesh
from repro_torch.launch import train as ttrain
from repro_torch.sharding.api import Runtime

REPO = Path(__file__).resolve().parents[1]
# C.R9: the decoder feed-forwards whisper-tiny's analytic count holds and
# its tree does not (4 blocks × (d + 3·d·d_ff), d 384, d_ff 1,536)
WHISPER_ANALYTIC, WHISPER_TREE = 41_492_736, 34_413_312
B, S = 2, 32
# the tracker's configs: one of each family (name: arch)
TRACKED = {"dense": "stablelm_1_6b", "ssm": "falcon_mamba_7b",
           "moe": "granite_moe_1b_a400m", "enc_dec": "whisper_tiny"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its ops are small, and
    the suite runs several test processes on one machine's cores, where
    more threads a process only contend.  The count is put back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the analytic counts
# ---------------------------------------------------------------------------

def test_shapes_are_the_references():
    from repro.configs import base as jbase
    assert list(tbase.SHAPES) == list(jbase.SHAPES)
    for name, shape in jbase.SHAPES.items():
        got = tbase.SHAPES[name]
        assert (got.name, got.seq_len, got.global_batch, got.mode) == (
            shape.name, shape.seq_len, shape.global_batch, shape.mode)


@pytest.mark.parametrize("shape", list(tbase.SHAPES))
@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_counts_equal_the_references(arch, shape):
    from repro.configs import base as jbase
    from repro.launch import hlo_analysis as jh
    for reduce in (False, True):
        tcfg, jcfg = get_arch(arch), jbase.get_arch(arch)
        if reduce:
            tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
        assert hlo_analysis.param_count(tcfg) == jh.param_count(jcfg)
        assert hlo_analysis.active_param_count(tcfg) == \
            jh.active_param_count(jcfg)
        assert hlo_analysis.model_flops(tcfg, tbase.SHAPES[shape]) == \
            jh.model_flops(jcfg, jbase.SHAPES[shape])


@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_fake_tree_counts_the_analytic_parameters(arch):
    cfg = get_arch(arch)
    counted = dryrun.counted_params(cfg)
    if arch == "whisper_tiny":
        # C.R9: the reference's count adds a feed-forward to every
        # decoder block, which neither package's init_params builds
        assert hlo_analysis.param_count(cfg) == WHISPER_ANALYTIC
        assert counted == WHISPER_TREE
        assert hlo_analysis.param_count(cfg) - counted == 7_079_424
    else:
        assert counted == hlo_analysis.param_count(cfg)


def test_roofline_terms():
    r = hlo_analysis.Roofline(flops=989e12, hbm_bytes=6.7e12,
                              model_flops=494.5e12)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.bound_s == pytest.approx(2.0)
    assert r.dominant == "memory"
    assert r.useful_ratio == pytest.approx(0.5)
    d = r.to_dict()
    assert "collective_s" not in d and d["dominant"] == "memory"
    assert hlo_analysis.Roofline(0.0, 0.0, 0.0).useful_ratio == 0.0


# ---------------------------------------------------------------------------
# the meshes
# ---------------------------------------------------------------------------

MESHES = {"for_4_4": ("make_mesh_for", (4, 4), {}),
          "for_8_2_pods2": ("make_mesh_for", (8, 2), {"pods": 2}),
          "for_16_4": ("make_mesh_for", (16, 4), {}),
          "production": ("make_production_mesh", (), {}),
          "production_multi": ("make_production_mesh", (),
                               {"multi_pod": True})}


@pytest.fixture(scope="module")
def jax_meshes():
    """The reference's axis names, sizes and batch axes of every mesh in
    MESHES, from one subprocess with 512 forced host devices."""
    script = textwrap.dedent(f"""
        import json
        from repro.launch import mesh
        out = {{}}
        for name, (fn, args, kw) in {MESHES!r}.items():
            m = getattr(mesh, fn)(*args, **kw)
            out[name] = dict(axis_names=list(m.axis_names),
                             shape={{k: int(v) for k, v in m.shape.items()}},
                             batch_axes=list(mesh.batch_axes_for(m)))
        print(json.dumps(out))
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_matches_the_references(jax_meshes, name):
    fn, args, kw = MESHES[name]
    m = getattr(mesh, fn)(*args, **kw)
    want = jax_meshes[name]
    assert list(m.axis_names) == want["axis_names"]
    assert m.shape == want["shape"]
    assert list(mesh.batch_axes_for(m)) == want["batch_axes"]
    assert m.mesh is None and m.q == m.slots == m.shape["model"]


def test_card_batch_is_one_data_shard():
    got = {name: dryrun.card_batch(shape)
           for name, shape in tbase.SHAPES.items()}
    assert got == {"train_4k": 16, "prefill_32k": 2, "decode_32k": 8,
                   "long_500k": 1}
    multi = {name: dryrun.card_batch(shape, multi_pod=True)
             for name, shape in tbase.SHAPES.items()}
    assert multi == {"train_4k": 8, "prefill_32k": 1, "decode_32k": 4,
                     "long_500k": 1}


# ---------------------------------------------------------------------------
# the memory tracker and the FLOP count: real against fake
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", list(TRACKED))
def test_tracker_real_equals_fake(family, mode):
    cfg = get_arch(TRACKED[family]).reduced()
    shape = ShapeConfig("t", S, B, mode)
    rt = Runtime(model_size=4, attn_chunk=16, loss_chunk=16,
                 scan_impl="reference", attn_impl="reference")
    real = dryrun.measure(*dryrun.build_step(cfg, shape, rt))
    with FakeTensorMode():
        fake = dryrun.measure(*dryrun.build_step(cfg, shape, rt))
    for field in ("peak_bytes", "argument_bytes", "output_bytes",
                  "aten_flops", "accessed_bytes"):
        assert getattr(real, field) == getattr(fake, field), field
    assert real.aten_flops > 0
    assert real.peak_bytes > real.argument_bytes > 0
    assert real.kernel_launches == fake.kernel_launches == {}
    if mode == "train":
        # the step returns new parameters: at least the f32 leaves' bytes
        params = sum(t.numel() * 4 for t in dryrun._tensors(
            dryrun.build_step(cfg, shape, rt)[1][0]))
        assert real.output_bytes >= params


def test_tracker_chain_of_matmuls():
    """x (64, 256) f32 through three (256, 256) weights: 64 KB a product
    and 256 KB a weight.  The arguments hold 64 + 3 × 256 KB; while the
    second product is made the first is alive (its name is bound), so
    the peak is the arguments and two products; a view adds nothing, and
    the FLOPs are 3 × 2·64·256·256."""
    kb = 1024
    x = torch.ones(64, 256)
    ws = [torch.ones(256, 256) for _ in range(3)]

    def chain(x, ws):
        h1 = x @ ws[0]
        h2 = h1 @ ws[1]
        del h1
        v = h2.view(-1)[:10]
        h3 = h2 @ ws[2]
        return h3, v

    for fake in (False, True):
        ctx = FakeTensorMode() if fake else torch.no_grad()
        with ctx:
            args = (torch.ones(64, 256), [torch.ones(256, 256)
                                         for _ in range(3)]) if fake \
                else (x, ws)
            cost = dryrun.measure(chain, args)
        assert cost.argument_bytes == 64 * kb + 3 * 256 * kb
        assert cost.peak_bytes == cost.argument_bytes + 2 * 64 * kb
        assert cost.output_bytes == 2 * 64 * kb       # h3 and h2 (the view)
        assert cost.aten_flops == 3 * 2 * 64 * 256 * 256
        assert cost.temp_bytes == 2 * 64 * kb


def test_tracker_rounds_to_blocks_and_frees():
    def step(a):
        t = torch.empty(3)                     # 12 bytes: one 512 block
        del t
        return torch.empty(1000, dtype=torch.uint8)   # 1,000: two blocks

    cost = dryrun.measure(step, (torch.empty(0),))
    assert cost.argument_bytes == 0
    assert cost.peak_bytes == 1024
    assert cost.output_bytes == 1024


# ---------------------------------------------------------------------------
# the wrappers' fake route
# ---------------------------------------------------------------------------

def _raise(*a, **k):
    raise AssertionError("a version ran on fake tensors")


def _randn(*shape, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype)


def _fake_and_plain(fn, make, monkeypatch):
    """(fake outputs, plain outputs, the fake route's tally) of
    ``fn(*make())``: the plain version first on real CPU tensors, then the
    fake route with every version patched to raise."""
    want = fn(*make())
    with monkeypatch.context() as m:
        for name in ("vfl_forward_ref", "vfl_backward_ref", "vfl_fused_ref",
                     "selective_scan", "attention_ref",
                     "decode_attention_ref"):
            m.setattr(ref, name, _raise)
        for mod in (vg, ops._ss, ops._fa, ops._da):
            m.setattr(mod.KERNEL, "_launch", _raise)
        for mode in ("forward", "backward", "fused"):
            m.setitem(ops._IMPLS, mode, (_raise,) + ops._IMPLS[mode][1:])
        with ops.fake_kernels() as tally, FakeTensorMode():
            got = fn(*make())
    return got, want, tally


def _same_meta(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert tuple(g.shape) == tuple(w.shape)
        assert g.dtype == w.dtype
        assert isinstance(g, ops.FakeTensor)


VFL_CASES = {
    # name: (mode, B, D, M, P, split); B > 1,024 takes the reduce program
    "forward_narrow": ("forward", 64, 512, 2, 8, None),
    "forward_wide": ("forward", 33, 40, 32, None, None),
    "backward_rows": ("backward", 32, 64, 1, 8, None),
    "backward_reduce": ("backward", 1500, 24, 3, None, None),
    "fused_split": ("fused", 64, 96, 1, 8, 32),
    "fused_rank2": ("fused", 48, 24, 2, None, None),
}


@pytest.mark.parametrize("name", list(VFL_CASES))
def test_vfl_grad_fake_route(name, monkeypatch):
    mode, b, d, m, p, split = VFL_CASES[name]
    lead = () if p is None else (p,)

    def make():
        xb = _randn(*lead, b, d)
        w = _randn(*lead, d, m, seed=1)
        nb = b if split is None else split
        theta = _randn(*lead, nb, m, seed=2)
        return xb, w, theta

    def fn(xb, w, theta):
        return ops.vfl_grad(xb, w, theta, 0.1 if mode == "fused" and
                            split is None else 0.0, mode=mode, split=split)

    got, want, tally = _fake_and_plain(fn, make, monkeypatch)
    _same_meta(got, want)
    n = 1 if p is None else p
    if mode == "forward":
        prog = "vfl_forward_narrow" if m <= vg.NARROW_MAX_M \
            else "vfl_forward_wide"
        assert tally.launches == {prog: 1}
        assert tally.flops[prog] == 2.0 * n * b * d * m
    elif mode == "backward":
        chunks = -(-b // vg.BWD_CHUNK_ROWS)
        want_l = {"vfl_backward_rows": 1}
        if chunks > 1:
            want_l["vfl_backward_reduce"] = 1
        assert tally.launches == want_l
        assert tally.flops["vfl_backward_rows"] == 2.0 * n * b * d * m
    else:
        assert tally.launches == {"vfl_fused_split": 1}
        nb = b if split is None else split
        assert tally.flops["vfl_fused_split"] == \
            2.0 * n * (b - (split or 0)) * d * m + 2.0 * n * nb * d * m


SCAN_CASES = {"small": (2, 16, 24, 8, torch.float32),
              "bf16": (1, 9, 40, 16, torch.bfloat16)}


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_selective_scan_fake_route(name, monkeypatch):
    b, s, c, n, dtype = SCAN_CASES[name]

    def make():
        return (_randn(b, s, c, dtype=dtype), _randn(b, s, c, seed=1).abs(),
                _randn(b, s, n, seed=2), _randn(b, s, n, seed=3),
                _randn(c, n, seed=4), _randn(c, seed=5))

    got, want, tally = _fake_and_plain(ops.selective_scan, make,
                                       monkeypatch)
    _same_meta(got, want)
    assert tally.launches == {"selective_scan": 1}
    assert tally.flops["selective_scan"] == \
        5.0 * b * s * c * n + 3.0 * b * s * c


FLASH_CASES = {"causal_window": (2, 4, 2, 40, 40, 32, True, 16,
                                 torch.bfloat16),
               "cross": (1, 3, 3, 12, 50, 64, False, None, torch.float32)}


def _pairs(sq, skv, causal, window):
    return sum(max(0, (min(skv, i + 1) if causal else skv)
                   - (0 if window is None else max(0, i - window + 1)))
               for i in range(sq))


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_attention_fake_route(name, monkeypatch):
    b, h, hkv, sq, skv, dh, causal, window, dtype = FLASH_CASES[name]

    def make():
        return (_randn(b, sq, h, dh, dtype=dtype).transpose(1, 2),
                _randn(b, skv, hkv, dh, dtype=dtype, seed=1).transpose(1, 2),
                _randn(b, skv, hkv, dh, dtype=dtype, seed=2).transpose(1, 2))

    def fn(q, k, v):
        return ops.flash_attention(q, k, v, causal=causal, window=window)

    got, want, tally = _fake_and_plain(fn, make, monkeypatch)
    _same_meta(got, want)
    assert tally.launches == {"flash_attention": 1}
    assert tally.flops["flash_attention"] == \
        4.0 * b * h * dh * _pairs(sq, skv, causal, window)


DECODE_CASES = {"sharded_window": (2, 8, 4, 64, 32, 4, 40, 16,
                                   torch.bfloat16),
                "one_shard": (1, 6, 6, 48, 24, None, 10, None,
                              torch.float32)}


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_attention_fake_route(name, monkeypatch):
    b, h, hkv, s, dh, shards, pos, window, dtype = DECODE_CASES[name]

    def make():
        return (_randn(b, h, dh, dtype=dtype),
                _randn(b, s, hkv, dh, dtype=dtype, seed=1),
                _randn(b, s, hkv, dh, dtype=dtype, seed=2))

    def fn(q, k, v):
        # the model's 0-d position, its int beside it
        at = torch.full((), pos, dtype=torch.int32, device=q.device)
        return ops.decode_attention(q, k, v, at, 0, window, shards=shards,
                                    pos_value=pos)

    got, want, tally = _fake_and_plain(fn, make, monkeypatch)
    _same_meta(got, want)
    valid = pos + 1 if window is None else min(pos + 1, window)
    assert tally.launches == {"decode_attention": 1}
    assert tally.flops["decode_attention"] == \
        4.0 * b * h * dh * valid


def test_decode_fake_route_needs_a_known_position():
    with ops.fake_kernels(), FakeTensorMode():
        q, kc = torch.empty(1, 2, 32), torch.empty(1, 16, 2, 32)
        with pytest.raises(ValueError, match="position"):
            ops.decode_attention(q, kc, kc, torch.full((), 3), 0)


def test_real_cpu_tensors_take_the_plain_version():
    """Real CPU tensors run the plain version, inside ``fake_kernels()``
    too, and tally nothing."""
    q = _randn(1, 2, 8, 32)
    with ops.fake_kernels() as tally:
        got = ops.flash_attention(q, q, q)
    torch.testing.assert_close(got, ref.attention_ref(q, q, q))
    assert not tally.launches


TRACED = {
    "selective_scan": lambda: (ops.selective_scan, (
        _randn(2, 6, 8), _randn(2, 6, 8, seed=1).abs(), _randn(2, 6, 4),
        _randn(2, 6, 4, seed=3), _randn(8, 4, seed=4), _randn(8, seed=5))),
    "flash_attention": lambda: (
        lambda q, k, v: ops.flash_attention(q, k, v, window=5),
        (_randn(1, 2, 12, 32), _randn(1, 2, 12, 32, seed=1),
         _randn(1, 2, 12, 32, seed=2))),
    "decode_attention": lambda: (
        lambda q, k, v: ops.decode_attention(q, k, v, 9, 0, None, shards=2),
        (_randn(1, 4, 32), _randn(1, 16, 2, 32, seed=1),
         _randn(1, 16, 2, 32, seed=2))),
}


@pytest.mark.parametrize("inside", [False, True], ids=["outside", "inside"])
@pytest.mark.parametrize("name", list(TRACED))
def test_fake_traces_record_the_plain_version(name, inside):
    """A ``make_fx(tracing_mode="fake")`` trace of a wrapper on CPU inputs,
    outside ``fake_kernels()`` or inside it, records the plain version:
    replayed on the inputs it gives the wrapper's values, and the fake
    route tallies nothing."""
    from torch.fx.experimental.proxy_tensor import make_fx
    fn, args = TRACED[name]()
    with ops.fake_kernels() if inside else contextlib.nullcontext() as tally:
        gm = make_fx(fn, tracing_mode="fake")(*args)
    torch.testing.assert_close(gm(*args), fn(*args), rtol=0, atol=0)
    assert not inside or not tally.launches


# ---------------------------------------------------------------------------
# the step functions and main()
# ---------------------------------------------------------------------------

def test_train_step_cast_bf16_matches_a_manual_cast():
    cfg = get_arch("stablelm_1_6b").reduced()
    rt = ttrain.build_runtime(2, reduced=True)
    step, (params, opt, batch, gen) = dryrun.build_step(
        cfg, ShapeConfig("t", S, B, "train"), rt, cast_bf16=True)
    loss, new, _ = step(params, opt, batch, gen)
    from repro_torch.core.secure_agg import mask_generator
    from repro_torch.models import model as tm
    from repro_torch.optim.tree import tree_map
    cast = tree_map(lambda a: a.to(torch.bfloat16), params)
    with torch.no_grad():
        want = tm.train_loss(rt, cfg, cast, batch,
                             mask_generator(dryrun.SEED, 0, device="cpu"))
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    assert all(t.dtype == torch.float32 for t in dryrun._tensors(new))


def test_main_writes_a_record_per_combination(tmp_path, capsys):
    dryrun.main(["--arch", "whisper_tiny", "--shape", "all",
                 "--out", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == [f"whisper_tiny_{s}_16x16.json"
                     for s in ("decode_32k", "prefill_32k", "train_4k")]
    assert "whisper_tiny × long_500k: skipped" in capsys.readouterr().out
    for f in tmp_path.iterdir():
        rec = json.loads(f.read_text())
        assert rec["status"] == "ok"
        assert rec["param_count"] == WHISPER_ANALYTIC
        assert rec["counted_params"] == WHISPER_TREE
        mem = rec["memory"]
        assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
        assert rec["fits"] is True
        assert rec["flops_per_device"] == rec["flops_aten"] + \
            rec["flops_kernels"] > 0
        assert rec["roofline"]["dominant"] in ("compute", "memory")
        if rec["mode"] != "train":
            assert rec["flops_kernels"] > 0 and rec["kernel_launches"]
    train = json.loads((tmp_path / "whisper_tiny_train_4k_16x16.json")
                       .read_text())
    assert train["batch"] == 16 and train["kernel_launches"] == {}


def test_main_exits_1_on_a_failing_combination(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(dryrun, "run_one", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "whisper_tiny", "--shape", "train_4k",
                     "--out", str(tmp_path)])
    assert e.value.code == 1


def test_unroll_extrapolates_per_unit():
    """--unroll 1 on whisper-tiny: the record's extrapolated FLOPs are the
    one-layer run's plus (4 − 1) times the per-layer difference, and the
    full-depth run's, exactly, on a shape where every layer costs the
    same; its peak lies within a tenth of the full run's."""
    kw = dict(out_dir="", quiet=True, batch=1)
    full = dryrun.run_one("whisper_tiny", "decode_32k", **kw)
    cut = dryrun.run_one("whisper_tiny", "decode_32k", unroll=1, **kw)
    ext = cut["extrapolated"]
    assert ext["units"] == 4
    assert ext["flops_aten"] == full["flops_aten"]
    assert ext["flops_kernels"] == full["flops_kernels"]
    assert ext["kernel_launches"] == full["kernel_launches"]
    assert abs(ext["memory"]["peak_bytes"] / full["memory"]["peak_bytes"]
               - 1) < 0.1
