"""The port's linter over device-mesh programs against the reference's.

Four gloo worlds on the CPU, spawned once through
``repro_torch.analysis.mesh.spawn``: the three of
``entrypoints.MESH_WORLDS`` (``flat``, 4 ranks of one party; ``hier``, 2
ranks of 2 parties; ``hier_ddp``, model 2 x data 2), each rank running
``mesh.lint_world`` on its own programs, and ``alone``, 2 ranks of which
one traces while the other does not.  The ranks' records are held to:

* the reference manifest ``analysis/INVARIANTS.json``: each entry x
  mode's taint codes on every rank equal the reference's entry of the
  same name (the flat world the flat names, ``hier`` the ``hier_*``,
  ``hier_ddp`` ``hier_sgd_ddp``), the ring verdicts its verdicts (the
  port's deep ring one flat ring, as on one device), no host transfer,
  a model-group collective and a party boundary on every rank, no c10d
  op without a rule; the flat world's per-rank collective volume equals
  ``["collectives"]`` and the one-device ``step_volume``;
* ``entrypoints.CENSUS``: ``vfl_grad`` nodes a step on every rank;
* the device-mesh mutants (each fires) and controls (each clean), the
  seed check (equal-seeded ranks caught), the release rule (the served
  answer released once a probe, a broadcast with another tag flagged),
  an unknown collective failing closed;
* the committed ``analysis/INVARIANTS_torch.json``: the merged report
  passes ``runner.check_mesh``; ``runner.main --mesh --quick --update``
  passes and writes the same mesh keys, and an ``--update`` without
  ``--mesh`` keeps them;
* the stacked-draw rule: a stack of draws masks a reduction over a rank's
  parties only where each row is another party's stream;
* no side effects: a traced epoch leaves a rank's inputs as they were and
  the next real epoch is bit-equal to one with no trace before it; one
  rank traces while the other waits outside every collective.
"""
import json
import os
import time

import pytest
import torch

from repro_torch.analysis import entrypoints as ep
from repro_torch.analysis import mesh, runner, volume
from repro_torch.analysis.taint import (EQUAL_SEEDED, UNMASKED,
                                        TaintFinding, seed_findings)

WORLDS = {**{w: v[0] for w, v in ep.MESH_WORLDS.items()}, "alone": 2}
#: the entries each world runs, by reference name
WORLD_ENTRIES = {w: [e.name for e in ep.world_entries(w)]
                 for w in ep.MESH_WORLDS}
MATRIX = [(w, m, e) for w in ep.MESH_WORLDS for m in ep.SECURE_MODES
          for e in WORLD_ENTRIES[w]]
#: the epochs whose trace must leave the rank as it was
SIDE_KINDS = ("sgd", f"delayed{ep.TAU}", "deep_sgd", f"faulted_sgd{ep.TAU}")
ALONE_WAIT = 120               # seconds the idle rank waits for the tracer


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs (its ops are small and
    its ranks share the machine's cores); the count is put back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the ranks (spawned; torch and the port only)
# ---------------------------------------------------------------------------

def _tensors(x):
    """The tensors of a nested result, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def _trace_side_effects(pm):
    """Each ``SIDE_KINDS`` epoch traced on the ring fixture: whether its
    inputs stayed as they were, then the next real epoch against the same
    epoch on a fixture that traced nothing."""
    out = {}
    for kind in SIDE_KINDS:
        fx, fresh = ep.Fixture("ring", "cpu", pm), ep.Fixture("ring", "cpu",
                                                               pm)
        ent = {e.name: e for e in ep.entries()}[kind]
        run = {
            "sgd": lambda f: f.eng.sgd_epoch(f.w, 0.1, f.idx),
            f"delayed{ep.TAU}": lambda f: f.eng.delayed_sgd_epoch(
                f.w, f.buf, 0, f.delays, 0.1, f.idx, ep.TAU),
            "deep_sgd": lambda f: f.eng.deep_sgd_epoch(f.deep_pq, 0.05,
                                                       f.idx),
            f"faulted_sgd{ep.TAU}": lambda f: f.eng.faulted_sgd_epoch(
                f.w, f.buf, 0, f.delays, f.fwdq, f.bwdq, f.extraq, 0.1,
                f.idx, ep.TAU)}[kind]
        inputs = (fx.w, fx.buf, fx.delays, fx.fwdq, fx.bwdq, *fx.deep_pq)
        before = [t.clone() for t in inputs]
        gm = ent.trace(fx.eng, fx)
        kept = all(torch.equal(a, b) for a, b in zip(before, inputs))
        got, want = _tensors(run(fx)), _tensors(run(fresh))
        out[kind] = {"program": isinstance(gm, torch.fx.GraphModule),
                     "inputs_kept": kept,
                     "next_epoch_equal": len(got) == len(want) > 0 and all(
                         torch.equal(a, b) for a, b in zip(got, want))}
    return out


def _probes(pm):
    """The release rule and an unknown collective, on a rank's (1, 8)
    partial: the answer's broadcast under another release tag, and a
    model-group ``all_gather_into_tensor`` (no rule)."""
    import torch.distributed as dist

    from repro_torch.analysis.taint import Analyzer, finding_codes
    from repro_torch.core.engine import trace_program
    from repro_torch.core.secure_agg import SERVED_ANSWER, trace_tag
    grp = pm.model_group

    def broadcast(tag):
        def fn(b):
            out = b["z"][0].clone()
            with trace_tag(collective="model", release=tag):
                dist.broadcast(out, dist.get_global_rank(grp, 0), group=grp)
            return out
        return fn

    def gather(b):
        out = torch.empty((dist.get_world_size(grp), 8))
        dist.all_gather_into_tensor(out, b["z"][0], group=grp)
        return out

    inputs = {"z": torch.zeros((1, 8))}
    out = {}
    for name, fn in (("released", broadcast(SERVED_ANSWER)),
                     ("other_tag", broadcast("a-partial")),
                     ("gather", gather)):
        an = Analyzer(trace_program(fn, inputs, {"z": 0}),
                      sources=("z",)).run()
        out[name] = {"codes": finding_codes(an.findings),
                     "released": an.released, "unknown": sorted(an.unknown)}
    return out


def _alone(base):
    """Rank 1 traces an epoch while rank 0 waits, in no collective, for
    its mark; returns how long the trace took and whether rank 0 saw it
    finish."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_device_mesh
    pm = make_device_mesh(2, q=ep.Q, backend="gloo", device="cpu")
    fx = ep.Fixture("ring", "cpu", pm)
    mark = os.path.join(base, "traced")
    if dist.get_rank() == 1:
        t0 = time.perf_counter()
        gm = fx.eng.sgd_epoch_graph(fx.w, 0.1, fx.idx)
        took = time.perf_counter() - t0
        with open(mark, "w") as f:
            f.write("traced")
        return {"traced": isinstance(gm, torch.fx.GraphModule),
                "seconds": took}
    deadline = time.monotonic() + ALONE_WAIT
    while not os.path.exists(mark) and time.monotonic() < deadline:
        time.sleep(0.05)
    return {"traced": False, "saw_trace": os.path.exists(mark)}


def _rank(world, base):
    if world == "alone":
        return _alone(base)
    rec = mesh.lint_world(world, device="cpu")
    if world == "flat":
        pm = mesh._mesh(world, "cpu")
        rec["side_effects"] = _trace_side_effects(pm)
        rec["probes"] = _probes(pm)
    return rec


# ---------------------------------------------------------------------------
# this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("dist_lint")
    return mesh.spawn(_rank, WORLDS, device="cpu", args=(str(base),),
                      timeout=600)


@pytest.fixture(scope="module")
def merged(worlds):
    return mesh.merge({w: worlds[w] for w in ep.MESH_WORLDS})


@pytest.fixture(scope="module")
def reference():
    return json.loads((runner.REPO_ROOT / "analysis"
                       / "INVARIANTS.json").read_text())


def _reports(worlds, world, mode, name):
    """Every rank's report of ``mode/name`` in ``world``."""
    out = [[r for r in rec["reports"]
            if (r["secure"], r["name"]) == (mode, name)]
           for rec in worlds[world]]
    assert all(len(r) == 1 for r in out), out
    return [r[0] for r in out]


# -- the matrix against the reference -------------------------------------------

@pytest.mark.parametrize("world,mode,name", MATRIX)
def test_taint_codes_match_reference(worlds, reference, world, mode, name):
    want = reference["matrix"][f"{mode}/{name}"]["taint"]
    for r in _reports(worlds, world, mode, name):
        assert r["taint"] == want, (r["taint"], want)


@pytest.mark.parametrize("world,mode,name", MATRIX)
def test_rings_transfers_and_collectives(worlds, reference, world, mode,
                                         name):
    want = reference["matrix"][f"{mode}/{name}"]
    for r in _reports(worlds, world, mode, name):
        assert r["host_transfers"] == want["host_transfers"] == 0
        assert r["collectives"] >= 1 and r["cross_party"] >= 1
        assert r["unknown"] == []
        assert bool(r["rings"]) == bool(want["rings"])
        for ring in r["rings"]:
            assert ring["bounded"] and ring["length"] == ep.TAU + 1, ring
            assert {ring["gated"]} == {x["gated"] for x in want["rings"]}
        # the deep ring is one flat ring (qloc rows), as on one device
        if r["rings"]:
            assert len(r["rings"]) == (1 if name.startswith("deep")
                                       else len(want["rings"]))


@pytest.mark.parametrize("world,mode,name", MATRIX)
def test_served_answer_released_once(worlds, world, mode, name):
    served = name in ("serve", "serve_delta", "deep_serve", "hier_serve")
    for r in _reports(worlds, world, mode, name):
        assert r["released"] == (1 if served else 0)


def test_merged_report_passes_committed_manifest(merged):
    manifest = json.loads(runner.DEFAULT_MANIFEST.read_text())
    errors, warnings = list(merged["_mesh_errors"]), []
    runner.check_mesh(merged, manifest, errors, warnings)
    assert errors == [] and warnings == []
    assert merged["_mesh_unknown"] == []
    assert len(merged["mesh_matrix"]) == len(MATRIX)


# -- volume and census ------------------------------------------------------------

@pytest.fixture(scope="module")
def one_device_volume():
    return volume.collective_volume(device="cpu")


@pytest.mark.parametrize("key", [f"{m}/{k}" for m in ("off", "two_tree",
                                                       "ring")
                                 for k in ("sgd", "delayed")])
def test_rank_volume_matches_reference(worlds, reference, one_device_volume,
                                       key):
    for rec in worlds["flat"]:
        assert rec["collectives"][key] == reference["collectives"][key] \
            == one_device_volume[key]


@pytest.mark.parametrize("kind", sorted(ep.CENSUS))
def test_kernel_census_on_every_rank(worlds, kind):
    for rec in worlds["flat"]:
        assert rec["kernels"][kind] == [ep.CENSUS[kind]]


@pytest.mark.parametrize("world", sorted(ep.MESH_WORLDS))
def test_lint_records_each_stage_seconds(worlds, world):
    stages = ["fixtures", "matrix", "seeds"] + (
        ["census", "volume", "mutants", "storage"] if world == "flat" else [])
    for rec in worlds[world]:
        assert list(rec["seconds"]) == stages
        assert all(t >= 0 for t in rec["seconds"].values())


# -- mutants, seeds, the release rule ----------------------------------------------

@pytest.mark.parametrize("name", ["dist_off_psum", "dist_same_seed",
                                  "dist_counter_unmasked",
                                  "dist_broadcast_partial",
                                  "dist_prev_only",
                                  "control_dist_two_tree",
                                  "control_dist_ring_members",
                                  "control_dist_tree_sf",
                                  "control_dist_seeds"])
def test_dist_mutants(worlds, name):
    for rec in worlds["flat"]:
        m = rec["mutants"][name]
        assert m["ok"], m
        assert bool(m["actual"]) == name.startswith("dist_")


@pytest.mark.parametrize("world,mode", [(w, m) for w in ep.MESH_WORLDS
                                        for m in ep.SECURE_MODES])
def test_seed_check_clean_on_every_world(worlds, world, mode):
    for rec in worlds[world]:
        assert rec["seeds"][mode] == {}


def _table(own, prev=None, slot=None):
    """One data shard's seed tables: rank p holds party p's own seed,
    its slot's where ``slot`` is given, and ``prev[p]`` as its ring's
    prev stream."""
    rows = []
    for p, seed in enumerate(own):
        row = [("own", "party", p, seed)]
        if slot is not None:
            row.append(("slot", "slot", p, slot[p]))
        if prev is not None:
            row.append(("prev", "party", (p - 1) % len(own), prev[p]))
        rows.append((0, row))
    return rows


@pytest.mark.parametrize("case,tables,n", [
    ("distinct", _table([1, 2, 3, 4], prev=[4, 1, 2, 3]), 0),
    ("own_equal", _table([1, 1, 3, 4]), 1),
    ("slot_equal", _table([1, 2, 3, 4], slot=[5, 5, 6, 7]), 1),
    ("prev_not_neighbour", _table([1, 2, 3, 4], prev=[4, 1, 3, 3]), 1),
    ("equal_and_prev", _table([1, 1, 3, 4], prev=[4, 1, 1, 3]), 1),
])
def test_seed_findings(case, tables, n):
    found = seed_findings(tables)
    assert all(isinstance(f, TaintFinding) and f.code == EQUAL_SEEDED
               for f in found)
    assert (len(found) >= 1) == bool(n), found


def test_release_rule_is_narrow(worlds):
    for rec in worlds["flat"]:
        p = rec["probes"]
        assert p["released"] == {"codes": {}, "released": 1, "unknown": []}
        assert p["other_tag"]["codes"] == {UNMASKED: 1}
        assert p["other_tag"]["released"] == 0


def test_unknown_collective_fails_closed(worlds):
    for rec in worlds["flat"]:
        g = rec["probes"]["gather"]
        assert g["unknown"] == ["c10d._allgather_base_"]
        assert g["codes"] == {UNMASKED: 1}


@pytest.mark.parametrize("parties,codes", [((0, 1), {}),
                                            ((0, 0), {EQUAL_SEEDED: 1})])
def test_stacked_draws_need_distinct_parties(parties, codes):
    """A rank's stack of its parties' draws masks the reduction over them
    only where each row is another party's stream: two draws of party 0's
    stream stacked as two parties are not distinct along the stack."""
    from repro_torch.analysis.taint import analyze_program, finding_codes
    from repro_torch.core.engine import trace_program
    from repro_torch.core.secure_agg import PartyStreams, _draws
    streams = PartyStreams((0, 1), 0, 2, 1, False, "cpu").seed(0, 1)
    gens = [streams.own[p] for p in parties]
    gm = trace_program(lambda b: (b["z"] + _draws((8,), gens, "cpu")).sum(0),
                       {"z": torch.zeros((2, 8))}, {"z": 0})
    assert finding_codes(analyze_program(gm, sources=("z",))) == codes


# -- the runner's --mesh stage ------------------------------------------------------

def _manifest_copy(tmp_path):
    path = tmp_path / "INVARIANTS_torch.json"
    path.write_text(runner.DEFAULT_MANIFEST.read_text())
    return path, json.loads(path.read_text())


def test_runner_mesh_stage_updates_manifest(tmp_path, capsys):
    """``--mesh --quick --update`` passes the committed manifest's gates,
    prints the mesh summary and writes this run's mesh keys, each entry
    as the committed one, and no per-rank detail."""
    path, before = _manifest_copy(tmp_path)
    rc = runner.main(["--mesh", "--quick", "--device", "cpu", "--manifest",
                      str(path), "--update", "--ci"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "analysis --mesh: 18 entries over 1 worlds" in out, out
    after = json.loads(path.read_text())
    assert sorted(k for k in after if k.startswith("mesh_")) \
        == sorted(runner.MESH_KEYS)
    assert len(after["mesh_matrix"]) == 18
    for key, entry in after["mesh_matrix"].items():
        assert entry == before["mesh_matrix"][key], key
    for key in ("mesh_collectives", "mesh_kernels"):
        assert after[key] == before[key]
    assert after["mesh_released"] == {
        k: v for k, v in before["mesh_released"].items()
        if k in after["mesh_matrix"]}


def test_runner_without_mesh_keeps_mesh_keys(tmp_path, capsys):
    """An ``--update`` run without ``--mesh`` carries the manifest's mesh
    keys over unchanged."""
    path, before = _manifest_copy(tmp_path)
    rc = runner.main(["--quick", "--device", "cpu", "--manifest", str(path),
                      "--update", "--ci"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "analysis --mesh" not in out
    after = json.loads(path.read_text())
    for key in runner.MESH_KEYS:
        assert after[key] == before[key], key


# -- no side effects ---------------------------------------------------------------

@pytest.mark.parametrize("kind", SIDE_KINDS)
def test_traced_epoch_leaves_the_rank_as_it_was(worlds, kind):
    for rec in worlds["flat"]:
        got = rec["side_effects"][kind]
        assert got == {"program": True, "inputs_kept": True,
                       "next_epoch_equal": True}, got


def test_a_rank_traces_alone(worlds):
    idle, tracer = worlds["alone"]
    assert tracer["traced"] and idle["saw_trace"], (idle, tracer)
    assert tracer["seconds"] < ALONE_WAIT
