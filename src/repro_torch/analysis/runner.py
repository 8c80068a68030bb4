"""Lint runner: the analysis passes, gated on the committed manifest
``analysis/INVARIANTS_torch.json``.

The counterpart of ``repro.analysis.runner``.  Stages, in order:

1. **mutant self-test** — the known-bad aggregations must each give their
   named finding and the shipped controls none (``mutants.py``);
2. **entry-point matrix** — every shipped entry traced under every
   security mode, with the hard gates of ``entrypoints.check_reports``;
3. **kernel census** — ``repro_torch.vfl_grad`` nodes a step for each
   kind of ``entrypoints.CENSUS``, each equal to the launches it names;
4. **storage identity** — a second SGD epoch reuses the first one's loop,
   buffers and graph (``schedule.storage_audit``; the reference's
   donation audit);
5. **volume** — bytes a party sends through the boundaries of one step of
   the ``sgd`` and ``delayed`` epochs (``volume.py``);
6. **device mesh** (``--mesh``) — the worlds of ``entrypoints.MESH_WORLDS``
   spawned as gloo ranks on the CPU (``--device cpu``) or NCCL ranks, one
   a card (``--device cuda``),
   each rank tracing its own programs (``mesh.py``): the matrix, the
   released answers, the flat world's census and per-rank collective
   volume, its storage audit and mutants, the seed check.  With
   ``--quick``, the flat world's quick entries under ``off``,
   ``two_tree`` and ``ring``.

The report is compared with the manifest: taint codes, host transfers,
ring verdicts, the census and the volumes must match exactly, and every
entry must keep a party-axis boundary; the mesh stage's ``mesh_matrix``
(codes, host transfers, ring verdicts, releases), ``mesh_released``,
``mesh_collectives`` and ``mesh_kernels`` likewise.  ``--update``
rewrites the manifest from a passing run (a run without ``--mesh`` keeps
the manifest's mesh keys); ``--ci`` prints GitHub ``::error``
annotations; the exit code is nonzero on any violation.

Device rule: ``--device`` defaults to ``cuda`` and raises without a card;
pass ``--device cpu`` to lint on the CPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, List, Optional

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_MANIFEST = REPO_ROOT / "analysis" / "INVARIANTS_torch.json"
#: the manifest keys of the device-mesh stage
MESH_KEYS = ("mesh_matrix", "mesh_released", "mesh_collectives",
             "mesh_kernels")


def normalize_rings(rings: List[dict]) -> List[dict]:
    """The stable core of a ring audit: slots and verdicts."""
    return [{"length": r["length"], "bounded": bool(r["bounded"]),
             "gated": bool(r["gated"])} for r in rings]


def build_report(quick: bool = False, with_volume: bool = True,
                 device="cuda", progress=None, indices=None,
                 mesh: bool = False) -> Dict:
    from repro_torch.analysis import entrypoints as ep
    from repro_torch.analysis import mutants as mu
    from repro_torch.analysis import volume as vol

    report: Dict = {"version": 1}
    report["mutants"] = {r.name: r.to_dict() for r in mu.run_selftest()}

    modes = ("off", "ring") if quick else ep.SECURE_MODES
    names = ep.QUICK if quick else None
    reps = ep.analyze_matrix(secure_modes=modes, names=names,
                             progress=progress, device=device,
                             indices=indices)
    report["matrix"] = {
        r.key: {"taint": dict(r.taint), "host_transfers": r.host_transfers,
                "cross_party": r.cross_party,
                "rings": normalize_rings(r.rings)}
        for r in reps}
    report["_matrix_errors"] = ep.check_reports(reps)
    report["_unknown_ops"] = sorted({op for r in reps for op in r.unknown})

    report["kernels"] = ep.kernel_census(tuple(ep.CENSUS), device=device,
                                         indices=indices)
    report["storage"] = storage_report(device, indices)
    if with_volume:
        report["collectives"] = vol.collective_volume(
            device=device, indices=indices, progress=progress)
    if mesh:
        from repro_torch.analysis import mesh as mesh_lint
        if progress is not None:
            progress("device mesh worlds")
        report.update(mesh_lint.run(quick=quick, device=device))
    return report


def storage_report(device="cuda", indices=None) -> dict:
    """Two SGD epochs of the ``ring`` fixture, the second against the
    first (``schedule.storage_audit``)."""
    from repro_torch.analysis import entrypoints as ep
    from repro_torch.analysis.schedule import storage_audit

    fx = ep.Fixture("ring", device, indices=indices)
    return storage_audit(fx.eng, lambda: fx.eng.sgd_epoch(
        fx.w, 0.1, fx.idx)).to_dict()


def check_report(report: Dict, manifest: Optional[Dict]):
    """Return (errors, warnings) for a report against the manifest."""
    from repro_torch.analysis import entrypoints as ep

    errors: List[str] = []
    warnings: List[str] = []
    for name, r in report["mutants"].items():
        if not r["ok"]:
            errors.append(f"mutant self-test '{name}': expected "
                          f"{r['expected']}, analyzer found {r['actual']}")
    errors.extend(report.get("_matrix_errors", []))
    for op in report.get("_unknown_ops", []):
        warnings.append(f"no taint rule for {op}: its operands' states "
                        f"were joined")
    for kind, got in report["kernels"].items():
        want = ep.CENSUS.get(kind)
        if want is not None and got != [want]:
            errors.append(f"kernel census {kind}: {got} vfl_grad nodes a "
                          f"step, the card launches {want}")
    if not report["storage"]["ok"]:
        errors.append(f"storage identity: a second epoch did not reuse the "
                      f"first one's loop: {report['storage']}")
    errors.extend(report.get("_mesh_errors", []))
    for op in report.get("_mesh_unknown", []):
        warnings.append(f"device mesh: no taint rule for {op}")
    for kind, got in report.get("mesh_kernels", {}).items():
        want = ep.CENSUS.get(kind)
        if want is not None and got != [want]:
            errors.append(f"device mesh kernel census {kind}: {got} "
                          f"vfl_grad nodes a rank's step, the card launches "
                          f"{want}")

    if manifest is None:
        warnings.append("no invariants manifest — run with --update to "
                        "commit one (structural gates still enforced)")
        return errors, warnings

    for key, want in manifest.get("matrix", {}).items():
        got = report["matrix"].get(key)
        if got is None:
            warnings.append(f"manifest entry {key} not analyzed this run")
            continue
        for field in ("taint", "host_transfers", "rings"):
            if got[field] != want[field]:
                errors.append(f"{key}: {field} drifted from manifest: "
                              f"{want[field]} -> {got[field]}")
        if got["cross_party"] < 1:
            errors.append(f"{key}: party-axis boundaries vanished")
    for key in report["matrix"]:
        if key not in manifest.get("matrix", {}):
            warnings.append(f"{key} analyzed but not in manifest "
                            f"(--update to record)")
    if report["kernels"] != manifest.get("kernels"):
        errors.append(f"kernel launch census drifted from manifest: "
                      f"{manifest.get('kernels')} -> {report['kernels']}")
    want_vol = manifest.get("collectives") or {}
    for key, got in (report.get("collectives") or {}).items():
        if key in want_vol and got != want_vol[key]:
            errors.append(f"collective volume {key} drifted from manifest: "
                          f"{want_vol[key]} -> {got}")
    if "mesh_matrix" in report:
        check_mesh(report, manifest, errors, warnings)
    return errors, warnings


def check_mesh(report: Dict, manifest: Dict, errors: List[str],
               warnings: List[str]) -> None:
    """The mesh stage's report against the manifest's ``mesh_*`` keys:
    each entry's codes, host transfers, ring verdicts and releases, the
    released answers, the per-rank volume and the census exactly; every
    rank keeps a party boundary."""
    want = manifest.get("mesh_matrix") or {}
    for key, got in report["mesh_matrix"].items():
        if key not in want:
            warnings.append(f"mesh {key} analyzed but not in manifest "
                            f"(--update --mesh to record)")
            continue
        for field in ("taint", "host_transfers", "rings", "released"):
            if got[field] != want[key][field]:
                errors.append(f"mesh {key}: {field} drifted from manifest: "
                              f"{want[key][field]} -> {got[field]}")
        if min(got["cross_party"]) < 1:
            errors.append(f"mesh {key}: party boundaries vanished on a "
                          f"rank")
    for key in want:
        if key not in report["mesh_matrix"]:
            warnings.append(f"manifest entry mesh {key} not analyzed this "
                            f"run")
    for field in ("mesh_released", "mesh_collectives", "mesh_kernels"):
        have = manifest.get(field) or {}
        for key, got in (report.get(field) or {}).items():
            if key in have and got != have[key]:
                errors.append(f"{field} {key} drifted from manifest: "
                              f"{have[key]} -> {got}")
            elif key not in have:
                warnings.append(f"{field} {key} not in manifest")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static security & schedule linter over the port's "
                    "traced programs.")
    ap.add_argument("--quick", action="store_true",
                    help="small entry subset, off/ring modes only")
    ap.add_argument("--ci", action="store_true",
                    help="GitHub ::error:: annotations on violations")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the invariants manifest from this run")
    ap.add_argument("--no-volume", action="store_true",
                    help="skip the boundary-volume stage")
    ap.add_argument("--manifest", type=pathlib.Path,
                    default=DEFAULT_MANIFEST)
    ap.add_argument("--json", type=pathlib.Path, default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--device", default="cuda",
                    help="where the fixture engines live (default cuda; "
                         "raises without a card)")
    ap.add_argument("--mesh", action="store_true",
                    help="also lint the device-mesh worlds: gloo ranks on "
                         "the CPU, NCCL ranks (one a card) on cuda")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    device = resolve_device(args.device)
    progress = (lambda s: print(f"  .. {s}", flush=True)) \
        if not args.ci else None
    report = build_report(quick=args.quick, with_volume=not args.no_volume,
                          device=device, progress=progress, mesh=args.mesh)

    manifest = None
    if args.manifest.exists():
        manifest = json.loads(args.manifest.read_text())
    errors, warnings = check_report(report, manifest)

    public = {k: v for k, v in report.items() if not k.startswith("_")}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(public, indent=1, sort_keys=True)
                             + "\n")
    if args.update:
        if errors:
            print("refusing to --update: structural gates failing",
                  file=sys.stderr)
        else:
            # the storage audit's byte count is the card's alone
            public["storage"] = {k: v for k, v in public["storage"].items()
                                 if k != "allocated_bytes"}
            # the mesh keys: this run's, or the manifest's where it ran
            # no mesh stage; per-rank details stay in --json
            for key in MESH_KEYS:
                if key not in public and manifest and key in manifest:
                    public[key] = manifest[key]
            for key in list(public):
                if key.startswith("mesh_") and key not in MESH_KEYS:
                    del public[key]
            args.manifest.parent.mkdir(parents=True, exist_ok=True)
            args.manifest.write_text(
                json.dumps(public, indent=1, sort_keys=True) + "\n")
            print(f"wrote {args.manifest}")

    n_rings = sum(len(v["rings"]) for v in report["matrix"].values())
    print(f"analysis: {len(report['matrix'])} entries, "
          f"{len(report['mutants'])} self-tests, {n_rings} ring audits, "
          f"{len(report.get('collectives', {}))} volume accounts")
    if args.mesh:
        print(f"analysis --mesh: {len(report['mesh_matrix'])} entries "
              f"over {len({k.split('/')[0] for k in report['mesh_matrix']})}"
              f" worlds, {len(report['mesh_mutants'])} self-tests, "
              f"{len(report['mesh_collectives'])} volume accounts, "
              f"{sum(report['mesh_released'].values())} released answers")
    for w in warnings:
        print(f"::warning::{w}" if args.ci else f"warning: {w}")
    for e in errors:
        print(f"::error::{e}" if args.ci else f"ERROR: {e}")
    if errors:
        return 1
    print("analysis: all gates passed")
    return 0
