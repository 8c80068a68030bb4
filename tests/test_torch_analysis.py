"""The port's linter (``repro_torch.analysis``) against the JAX package's.

* the ``repro_torch::vfl_grad`` operator: one node per call in a trace,
  its shape-only implementation matching the plain one in every mode;
* the engine's trace interface: ``party_program`` and its ``KeyError``,
  the probes, the step's marks, a traced epoch that leaves its state
  untouched, the serving probes (the cache hit crosses no boundary);
* the quick matrix under ``off``/``ring``/``two_tree`` against
  ``repro.analysis.entrypoints.analyze_matrix`` on the same names: the
  same taint code sets, no host transfers, boundaries on both sides;
* the seven mutants and controls against ``repro.analysis.mutants``
  (``no_rekey`` maps to the port's membership code);
* the kernel census against the reference's ``kernel_census()`` and, for
  the deep and delayed kinds, the launches a step makes on the card;
* all 100 (mode, entry) pairs against the committed
  ``analysis/INVARIANTS.json``: taint code sets, host transfers, every
  ring bounded with the manifest's gating over τ + 1 slots, and the six
  per-step volumes;
* the counterparts of the reference's gate tests, the storage-identity
  check, the CLI's exit codes and the committed
  ``analysis/INVARIANTS_torch.json`` against a quick run.

The engines are the reference's fixture (N, D, Q, M = 48, 12, 4, 2;
batch 8; 3 steps; τ 2) on the CPU, fed the reference's ``_batch_indices``
schedule.  JAX is imported inside module-scoped fixtures.
"""
import json

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.analysis import entrypoints as ep
from repro_torch.analysis import mutants as mu
from repro_torch.analysis import runner, volume
from repro_torch.analysis.schedule import Intervals, ring_audit
from repro_torch.analysis.taint import (EQUAL_SEEDED, MASK_REUSED, UNMASKED,
                                        analyze_program, boundaries,
                                        finding_codes)
from repro_torch.analysis.walkers import (count_cross_party,
                                          count_host_transfers, count_op,
                                          target_histogram, vfl_grad_census)
from repro_torch.core import engine
from repro_torch.core.engine import trace_program
from repro_torch.core.secure_agg import seed_generator
from repro_torch.kernels import ops, ref

MODES = ("off", "ring", "two_tree")
FULL = [(m, e) for m in ep.SECURE_MODES for e in ep.entry_names()]


@pytest.fixture(scope="module")
def jx():
    import jax

    from repro.analysis import entrypoints as ref_ep
    from repro.analysis import mutants as ref_mu
    from repro.core import algorithms as ref_alg
    return jax, ref_ep, ref_mu, ref_alg


@pytest.fixture(scope="module")
def indices(jx):
    jax, _, _, ref_alg = jx

    def draw(n, batch, steps):
        return np.asarray(ref_alg._batch_indices(jax.random.key(7), n,
                                                 batch, steps))
    return draw


@pytest.fixture(scope="module")
def port_reports(indices):
    reps = ep.analyze_matrix(device="cpu", indices=indices)
    return {r.key: r for r in reps}


@pytest.fixture(scope="module")
def ref_quick(jx):
    reps = jx[1].analyze_matrix(secure_modes=MODES, names=ep.QUICK)
    return {r.key: r for r in reps}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((runner.REPO_ROOT / "analysis"
                       / "INVARIANTS.json").read_text())


@pytest.fixture(scope="module")
def quick_report():
    return runner.build_report(quick=True, device="cpu")


# -- the vfl_grad operator -----------------------------------------------------

def _operands(mode, lead):
    g = torch.Generator().manual_seed(0)
    pre = (3,) if lead else ()
    x = torch.randn(pre + (10, 5), generator=g)
    w = torch.randn(pre + (5, 2), generator=g)
    th = torch.randn(pre + (10, 2), generator=g)
    if mode == "forward":
        return (x, w), dict(mode="forward")
    if mode == "backward":
        return (x, None, th), dict(mode="backward", denom=4)
    return (x, w, th[..., :6, :]), dict(mode="fused", split=6)


@pytest.mark.parametrize("mode", ["forward", "backward", "fused"])
@pytest.mark.parametrize("lead", [False, True])
def test_vfl_grad_is_one_operator_node(mode, lead):
    args, kw = _operands(mode, lead)
    want = ops.vfl_grad(*args, **kw)
    gm = make_fx(lambda *a: ops.vfl_grad(*a, **kw))(*args)
    assert count_op(gm, "repro_torch.vfl_grad") == 1
    hist = target_histogram(gm)
    assert hist[f"repro_torch.vfl_grad.{mode}"] == 1
    assert not [k for k in hist if k.startswith("aten.")]      # no bmm
    fake = make_fx(lambda *a: ops.vfl_grad(*a, **kw),
                   tracing_mode="fake")(*args)
    (node,) = [n for n in fake.graph.nodes
               if str(n.target).startswith("repro_torch.vfl_grad")]
    val = node.meta["val"]
    vals = val if isinstance(val, tuple) else (val,)
    got = [t for t in want if t is not None]
    assert [tuple(v.shape) for v in vals] == [tuple(t.shape) for t in got]
    if mode == "forward":
        torch.testing.assert_close(want[0], ref.vfl_forward_ref(*args))


def test_host_transfer_walker():
    """A host read of a device value, a size read and a copy from the card
    to the CPU count; a copy within one device does not."""
    from types import SimpleNamespace

    graph = torch.fx.Graph()
    x = graph.placeholder("x")
    x.meta["val"] = SimpleNamespace(device="cuda")
    aten = torch.ops.aten
    for op, dev in ((aten._local_scalar_dense.default, "cpu"),
                    (aten.nonzero.default, "cuda"),
                    (aten._to_copy.default, "cpu"),
                    (aten._to_copy.default, "cuda")):
        graph.call_function(op, (x,)).meta["val"] = \
            SimpleNamespace(device=dev)
    assert count_host_transfers(graph) == 3
    assert count_op(graph, "aten._to_copy") == 2


# -- the engine's trace interface ------------------------------------------------

def test_party_program_names_the_built_kinds():
    fx = ep.Fixture("ring", "cpu")
    fx.eng.sgd_epoch_graph(fx.w, 0.1, fx.idx)
    with pytest.raises(KeyError, match=r"\['sgd'\]"):
        fx.eng.party_program("delayed2")


def test_traced_epoch_leaves_state_and_runs_nothing():
    fx = ep.Fixture("two_tree", "cpu")
    w0 = fx.w.clone()
    out = fx.eng.sgd_epoch_graph(fx.w, 0.1, fx.idx)
    assert torch.equal(fx.w, w0)
    # the loop's generator is seeded for the epoch and has drawn nothing
    seeded = seed_generator(torch.Generator(), 0, engine._TAG_STEPS)
    assert torch.equal(fx.eng._gen.get_state(), seeded.get_state())
    (loop,) = fx.eng._loops.values()
    assert torch.equal(loop.bufs["wq"], w0)
    assert int(loop.bufs["t"]) == 0
    # the step's nodes are marked; the feature block is named by identity
    assert any(n.meta.get("step") for n in out.graph.nodes)
    (src,) = [k for k, (_, s) in out.meta["consts"].items() if s]
    assert getattr(out, src) is fx.eng.xs
    # the epoch still runs as before afterwards
    w1 = fx.eng.sgd_epoch(fx.w, 0.1, fx.idx)
    assert torch.isfinite(w1).all() and not torch.equal(w1, w0)


@pytest.mark.parametrize("probe", ["pipelined_sgd", "deep_sgd",
                                   "deep_pipelined_sgd", "faulted_sgd2",
                                   "guarded_sgd2_1"])
def test_probes_record_their_kind(probe):
    fx = ep.Fixture("ring", "cpu")
    calls = {
        "pipelined_sgd": lambda e: e.pipelined_sgd_epoch_graph(
            fx.w, 0.1, fx.idx),
        "deep_sgd": lambda e: e.deep_sgd_epoch_graph(fx.deep_pq, 0.05,
                                                     fx.idx),
        "deep_pipelined_sgd": lambda e: e.deep_pipelined_sgd_epoch_graph(
            fx.deep_pq, 0.05, fx.idx),
        "faulted_sgd2": lambda e: e.faulted_sgd_epoch_graph(
            fx.w, fx.buf, 0, fx.delays, fx.fwdq, fx.bwdq, fx.extraq, 0.1,
            fx.idx, ep.TAU),
        "guarded_sgd2_1": lambda e: e.guarded_sgd_epoch_graph(
            fx.w, fx.buf, 0, fx.delays, fx.fwdq, fx.bwdq, fx.extraq,
            fx.corruptq, 0.1, fx.idx, ep.TAU)}
    gm = calls[probe](fx.eng)
    assert fx.eng.party_program(probe) is gm
    assert vfl_grad_census(gm) == ep.CENSUS[probe]
    assert count_host_transfers(gm) == 0


def test_serve_hit_crosses_no_boundary():
    fx = ep.Fixture("two_tree", "cpu")
    for sv in (fx.serve, fx.deep_serve):
        hit = sv.serve_hit_graph()
        assert boundaries(hit) == [] and count_cross_party(hit) == 0
        assert analyze_program(hit) == []
        assert len(boundaries(sv.serve_full_graph())) == 2


# -- the quick matrix against the reference --------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ep.QUICK)
def test_quick_matrix_matches_reference(port_reports, ref_quick, mode, name):
    mine, theirs = port_reports[f"{mode}/{name}"], ref_quick[f"{mode}/{name}"]
    assert set(mine.taint) == set(theirs.taint), (mine.taint, theirs.taint)
    assert mine.host_transfers == theirs.host_transfers == 0
    assert mine.cross_party >= 1 and theirs.cross_party >= 1
    assert mine.unknown == []


# -- mutants ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def mutant_pairs(jx):
    mine = {r.name: r for r in mu.run_selftest()}
    theirs = {r.name: r for r in jx[2].run_selftest()}
    return mine, theirs


@pytest.mark.parametrize("name", ["off_psum", "equal_seeded", "no_rekey",
                                  "control_two_tree", "control_ring_members",
                                  "hier_inner_only", "control_hier"])
def test_mutants_match_reference(mutant_pairs, name):
    mine, theirs = mutant_pairs
    assert mine[name].ok, mine[name]
    want = {MASK_REUSED if c == "mask-not-membership-keyed" else c
            for c in theirs[name].actual}
    assert set(mine[name].actual) == want


def test_no_rekey_only_flagged_under_membership():
    gm = mu.trace(mu.no_rekey, alive=torch.ones(mu.Q),
                  alive2=torch.ones(mu.Q))
    assert finding_codes(analyze_program(gm, sources=("z",))) == {}
    flagged = finding_codes(analyze_program(gm, True, sources=("z",)))
    assert flagged.get(MASK_REUSED, 0) >= 1


def test_is_finite_declassification():
    """Shipping only the finiteness verdict of a private partial is clean;
    shipping the partial flags."""
    def health_only(b):
        return torch.isfinite(b["z"]).all(1).float().sum(0)

    def raw_leak(b):
        return b["z"].sum(0)

    z = {"z": torch.ones((4, 8))}
    gm = trace_program(health_only, z, {"z": 0})
    assert analyze_program(gm, sources=("z",)) == []
    assert len(boundaries(gm)) == 1
    gm2 = trace_program(raw_leak, z, {"z": 0})
    assert finding_codes(analyze_program(gm2, sources=("z",))) \
        == {UNMASKED: 1}


def test_equal_seeded_two_level_rule():
    """A draw per logical party is distinct; one repeated over the slots
    is not, at either level."""
    codes = finding_codes(analyze_program(mu.trace(mu.hier_inner_only),
                                          sources=("z",)))
    assert codes == {EQUAL_SEEDED: 2}


# -- the kernel census -----------------------------------------------------------

def test_kernel_census_matches_reference(jx, indices):
    assert ep.kernel_census(device="cpu", indices=indices) \
        == jx[1].kernel_census() == {"sgd": [2], "pipelined_sgd": [1]}


def test_kernel_census_of_every_kind(indices):
    got = ep.kernel_census(tuple(ep.CENSUS), device="cpu", indices=indices)
    assert got == {k: [v] for k, v in ep.CENSUS.items()}


# -- the full matrix against the reference's manifest ----------------------------

@pytest.mark.parametrize("key", [f"{m}/{e}" for m, e in FULL])
def test_full_matrix_matches_manifest(port_reports, manifest, key):
    mine, want = port_reports[key], manifest["matrix"][key]
    assert set(mine.taint) == set(want["taint"])
    assert mine.host_transfers == want["host_transfers"] == 0
    assert mine.cross_party >= 1
    assert mine.unknown == []
    assert bool(mine.rings) == bool(want["rings"])
    for ring in mine.rings:
        assert ring["bounded"], ring
        assert ring["length"] == ep.TAU + 1
        assert {ring["gated"]} == {r["gated"] for r in want["rings"]}
    # the flat deep ring stands for the reference's three
    if mine.rings:
        assert len(mine.rings) == (1 if key.split("/")[1].startswith("deep")
                                   else len(want["rings"]))


def test_check_reports_pass_on_full_matrix(port_reports):
    assert ep.check_reports(list(port_reports.values())) == []


def test_volume_matches_manifest(manifest, indices):
    got = volume.collective_volume(device="cpu", indices=indices)
    assert got == manifest["collectives"]


# -- gate tests (the reference's counterparts) -----------------------------------

def test_intervals_prove_mod_bounds():
    gm = make_fx(lambda t: (t - 5).clamp_min(0) % 3, tracing_mode="fake")(
        torch.zeros((), dtype=torch.int64))
    out = [n for n in gm.graph.nodes if n.op == "call_function"][-1]
    assert Intervals(gm).get(out) == (0.0, 2.0)


def test_intervals_unknown_primitive_fails_closed():
    gm = make_fx(lambda t: torch.sin(t.float()), tracing_mode="fake")(
        torch.zeros((), dtype=torch.int64))
    out = [n for n in gm.graph.nodes if n.op == "call_function"][-1]
    lo, hi = Intervals(gm).get(out)
    assert lo == float("-inf") and hi == float("inf")


def _ring_step(read_mod):
    tau = ep.TAU

    def step(b):
        buf, t = b["buf"], b["t"]
        g = torch.ones((4, 1, 3)) * t
        buf.index_copy_(1, (t % (tau + 1)).view(1), g)
        idx = ((t - 1).clamp_min(0) % read_mod).view(1, 1, 1).expand(4, 1, 3)
        b["out"].copy_(buf.gather(1, idx).squeeze(1))
        t.add_(1)

    inputs = {"buf": torch.zeros((4, tau + 1, 3)),
              "t": torch.zeros((), dtype=torch.int64),
              "out": torch.zeros((4, 3))}
    return trace_program(step, inputs, {"buf": 0, "t": None, "out": 0})


def test_ring_read_within_the_ring_is_bounded():
    (audit,) = ring_audit(_ring_step(ep.TAU + 1), ep.TAU)
    assert audit.bounded and not audit.gated and audit.reads == 1


def test_oversized_ring_read_fails_the_proof():
    # a read mod (τ+2) over a (τ+1)-slot ring: the interval [0, τ+1]
    # exceeds it
    (audit,) = ring_audit(_ring_step(ep.TAU + 2), ep.TAU)
    assert not audit.bounded
    assert any("read index interval" in note for note in audit.notes)


def test_check_reports_gates_on_leak():
    reps = ep.analyze_matrix(secure_modes=("off", "ring"), names=("sgd",),
                             device="cpu")
    assert ep.check_reports(reps) == []
    blind, leaky = reps
    blind.taint = {}
    leaky.taint = {UNMASKED: 1}
    errs = ep.check_reports(reps)
    assert any("vacuity" in e for e in errs)
    assert any("leaks" in e for e in errs)


def test_unmasked_mutant_fails_the_gates(quick_report):
    report = dict(quick_report)
    report["mutants"] = dict(report["mutants"])
    report["mutants"]["off_psum"] = {"expected": {UNMASKED: 1},
                                     "actual": {}, "ok": False}
    errors, _ = runner.check_report(report, None)
    assert any("off_psum" in e for e in errors)


def test_check_report_flags_manifest_drift(quick_report):
    manifest = json.loads(runner.DEFAULT_MANIFEST.read_text())
    assert runner.check_report(quick_report, manifest)[0] == []
    drifted = json.loads(json.dumps(manifest))
    drifted["matrix"]["ring/sgd"]["taint"] = {UNMASKED: 1}
    errors, _ = runner.check_report(quick_report, drifted)
    assert any("ring/sgd: taint drifted" in e for e in errors)


def test_guarded_entries_lint_like_faulted(port_reports):
    for mode in ep.SECURE_MODES:
        r = port_reports[f"{mode}/guarded_sgd{ep.TAU}_1"]
        assert r.membership and r.gated
        assert all(ring["gated"] for ring in r.rings)
        if mode != "off":
            assert r.taint == {}
    r = port_reports[f"ring/guarded_sgd{ep.TAU}_1"]
    r_off = ep.EntryReport(**{**r.__dict__, "membership": False})
    assert any("membership" in e for e in ep.check_reports([r_off]))


def test_committed_manifest_matches_quick_run(quick_report):
    manifest = json.loads(runner.DEFAULT_MANIFEST.read_text())
    for key, got in quick_report["matrix"].items():
        want = manifest["matrix"][key]
        assert got["taint"] == want["taint"], key
        assert got["host_transfers"] == want["host_transfers"], key
        assert got["rings"] == want["rings"], key
    assert quick_report["kernels"] == manifest["kernels"]
    assert quick_report["collectives"] == manifest["collectives"]
    assert manifest["storage"]["ok"]


def test_storage_identity(quick_report):
    assert quick_report["storage"] == {
        "loops": 1, "same_loop": True, "same_storage": True,
        "same_graph": True, "allocated_bytes": None, "ok": True}


# -- the CLI ---------------------------------------------------------------------

def test_cli_quick_passes_and_fails_on_drift(tmp_path, capsys):
    assert runner.main(["--quick", "--device", "cpu", "--no-volume",
                        "--json", str(tmp_path / "r.json")]) == 0
    assert "all gates passed" in capsys.readouterr().out
    manifest = json.loads(runner.DEFAULT_MANIFEST.read_text())
    manifest["matrix"]["off/sgd"]["host_transfers"] = 1
    bad = tmp_path / "drift.json"
    bad.write_text(json.dumps(manifest))
    assert runner.main(["--quick", "--device", "cpu", "--no-volume",
                        "--manifest", str(bad)]) == 1
    assert "off/sgd: host_transfers drifted" in capsys.readouterr().out
