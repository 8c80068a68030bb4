"""The linter over device-mesh programs: worlds of ranks, spawned and
gathered.

The counterpart of the reference's lint of per-party programs on a real
``("model",)`` mesh.  On ``PartyMesh(mesh=DeviceMesh)`` every rank traces
its own programs (``FusedEngine.tracing``, the serving probes), whose
party boundaries are the c10d collectives over the model group
(:mod:`repro_torch.analysis.taint`), and runs the passes on them:

* :func:`lint_world` — one rank's part of a world of
  ``entrypoints.MESH_WORLDS``: the world's entries under each security
  mode (taint, ring audit, host transfers, the model group's collectives,
  the released answers), the seed check of its mask streams against
  every other rank's (``taint.seed_findings``), and, in the flat world,
  the ``vfl_grad`` census, the volume of the model group's collectives
  (``volume.rank_volume``), the storage audit of a rank's rings and the
  device-mesh mutants (``mutants.run_dist_selftest``); the storage audit
  outside the quick form; ``seconds``, each stage's on the host clock
  (the engines' build, the matrix's traces, the seed check, ...).  Every rank of the world calls it, the entries
  in the same order.
* :func:`merge` — the ranks' records into the report's ``mesh_*`` parts:
  each entry's taint codes, host transfers, ring verdicts and releases,
  which every rank must give alike, beside each rank's boundary and
  collective counts.
* :func:`start` and :func:`spawn` — start worlds of ranks, each rank in
  a spawned process (a ``FileStore`` in a temporary directory, one torch
  thread a rank), run a function in each and gather the records (a rank
  leaves by ``os._exit`` once its record is written: a gloo thread still
  joinable at interpreter exit can abort it).  gloo on the CPU for
  ``device="cpu"``; NCCL, one rank a card, for ``device="cuda"``.  The
  runner, ``tests/test_torch_dist_lint.py`` and the rank tests of the
  device mesh (``test_torch_dist_mesh.py``, ``_deep.py``, ``_faults.py``)
  spawn through it; ``start`` lets a caller compute its reference while
  the ranks run.
* :func:`run` — spawn the worlds, merge: ``python -m repro_torch.analysis
  --mesh`` (``runner.py``).

The quick form is the flat world's quick entries (``QUICK`` less the
packings) under ``off``, ``two_tree`` and ``ring``, with the census, the
volume and the mutants; ``two_tree_sf`` replays its trees by point-to-
point sends, which gloo refuses for CUDA tensors, so it runs on the CPU
only.

Device rule: :func:`run`, :func:`start`, :func:`spawn` and
:func:`lint_world` default to ``device="cuda"`` and raise without a card;
pass ``device="cpu"`` for gloo ranks on the CPU.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import torch

#: the quick form's security modes (the full form's: every one of
#: ``entrypoints.SECURE_MODES`` on the CPU; two_tree_sf on the CPU only)
QUICK_MODES = ("off", "two_tree", "ring")
#: the key every rank seeds its streams from for the seed check (an
#: epoch's: mask key (0,), the steps' tag)
SEED_KEY = (0, 0x5EC)
SPAWN_TIMEOUT = 600            # seconds a world may take


def _modes(device, quick: bool) -> Sequence[str]:
    from repro_torch.analysis import entrypoints as ep
    cpu = torch.device(device).type == "cpu"
    return QUICK_MODES if quick or not cpu else ep.SECURE_MODES


def world_names(quick: bool) -> Sequence[str]:
    """The worlds the mesh stage runs: the flat one alone when quick."""
    from repro_torch.analysis import entrypoints as ep
    return ("flat",) if quick else tuple(ep.MESH_WORLDS)


def _mesh(world: str, device):
    from repro_torch.analysis import entrypoints as ep
    from repro_torch.launch.mesh import make_device_mesh
    import torch.distributed as dist
    ranks, model, _ = ep.MESH_WORLDS[world]
    if dist.get_world_size() != ranks:
        raise ValueError(f"the {world} world has {ranks} ranks; this "
                         f"process group {dist.get_world_size()}")
    return make_device_mesh(model, q=ep.Q, backend=str(dist.get_backend()),
                            device=device)


def lint_world(world: str, quick: bool = False, device="cuda",
               progress: Optional[Callable[[str], None]] = None) -> dict:
    """This rank's record of ``world`` (``entrypoints.MESH_WORLDS``) on the
    initialised default process group, which must be the world's size.
    Every rank calls it."""
    import torch.distributed as dist

    from repro_torch.analysis import entrypoints as ep
    from repro_torch.analysis import mutants as mu
    from repro_torch.analysis import volume as vol
    from repro_torch.analysis.schedule import storage_audit
    from repro_torch.analysis.taint import finding_codes, seed_findings

    pm = _mesh(world, device)
    modes = _modes(device, quick)
    names = [e.name for e in ep.world_entries(world)
             if not quick or e.name in ep.QUICK]
    seconds: Dict[str, float] = {}      # each stage's, host clock
    clock = [time.perf_counter()]

    def lap(stage: str) -> None:
        now = time.perf_counter()
        seconds[stage], clock[0] = now - clock[0], now

    # one engine a mode, built once and shared by every pass below
    fixtures: Dict = {}
    for secure in modes:
        ep.fixture(secure, device, pm, cache=fixtures)
    lap("fixtures")
    reports = ep.analyze_matrix(modes, names, progress, device, mesh=pm,
                                fixtures=fixtures)
    lap("matrix")
    rec = {"world": world, "rank": dist.get_rank(), "slot": pm.slot,
           "data_index": pm.data_index,
           "reports": [dataclasses.asdict(r) for r in reports],
           "seeds": {}, "seconds": seconds}
    for secure in modes:
        eng = ep.fixture(secure, device, pm, cache=fixtures).eng
        tables = [None] * dist.get_world_size()
        dist.all_gather_object(tables, (pm.data_index,
                                        eng.mask_streams(*SEED_KEY).seeds()))
        rec["seeds"][secure] = finding_codes(seed_findings(tables))
    lap("seeds")
    if world == "flat":
        rec["kernels"] = ep.kernel_census(tuple(ep.CENSUS), device,
                                          mesh=pm, fixtures=fixtures)
        lap("census")
        rec["collectives"] = vol.collective_volume(device=device, mesh=pm,
                                                   fixtures=fixtures)
        lap("volume")
        rec["mutants"] = {r.name: r.to_dict()
                          for r in mu.run_dist_selftest(pm, device)}
        lap("mutants")
        if not quick:           # two real epochs of the ring fixture, last
            fx = ep.fixture("ring", device, pm, cache=fixtures)
            rec["storage"] = storage_audit(
                fx.eng, lambda: fx.eng.delayed_sgd_epoch(
                    fx.w, fx.buf, 0, fx.delays, 0.1, fx.idx,
                    ep.TAU)).to_dict()
            lap("storage")
    return rec


def merge(records: Dict[str, List[dict]]) -> dict:
    """The report's device-mesh parts from every world's rank records:
    ``mesh_matrix`` (``"<world>/<mode>/<entry>"``: taint codes, host
    transfers, ring verdicts and releases, alike on every rank, and each
    rank's party boundaries and model-group collectives),
    ``mesh_released`` (the entries that release a served answer),
    ``mesh_collectives`` and ``mesh_kernels`` (the flat world's, alike on
    every rank), ``mesh_mutants``, ``mesh_storage`` and ``mesh_seeds``;
    ``_mesh_errors`` holds every gate that failed."""
    from repro_torch.analysis import entrypoints as ep
    from repro_torch.analysis.runner import normalize_rings

    out = {"mesh_matrix": {}, "mesh_released": {}, "mesh_collectives": {},
           "mesh_kernels": {}, "mesh_mutants": {}, "mesh_storage": {},
           "mesh_seeds": {}, "_mesh_errors": [], "_mesh_unknown": []}
    errors = out["_mesh_errors"]

    def alike(what, vals):
        if any(v != vals[0] for v in vals[1:]):
            errors.append(f"mesh {what}: the ranks disagree: {vals}")
        return vals[0]

    for world, recs in sorted(records.items()):
        recs = sorted(recs, key=lambda r: r["rank"])
        for row in zip(*(r["reports"] for r in recs)):
            reps = [ep.EntryReport(**r) for r in row]
            key = f"{world}/{reps[0].key}"
            for rank, r in enumerate(reps):
                errors.extend(f"mesh {world} rank {rank}: {e}"
                              for e in ep.check_reports([r]))
                out["_mesh_unknown"].extend(r.unknown)
            entry = {f: alike(f"{key} {f}", [getattr(r, f) for r in reps])
                     for f in ("taint", "host_transfers", "released")}
            entry["rings"] = alike(f"{key} rings", [normalize_rings(r.rings)
                                                    for r in reps])
            entry["cross_party"] = [r.cross_party for r in reps]
            entry["collectives"] = [r.collectives for r in reps]
            out["mesh_matrix"][key] = entry
            if entry["released"]:
                out["mesh_released"][key] = entry["released"]
        for secure in recs[0]["seeds"]:
            codes = alike(f"{world}/{secure} seeds",
                          [r["seeds"][secure] for r in recs])
            out["mesh_seeds"][f"{world}/{secure}"] = codes
            if codes:
                errors.append(f"mesh {world}/{secure}: the seed check "
                              f"failed: {codes}")
        if "kernels" in recs[0]:
            out["mesh_kernels"] = alike("kernels",
                                        [r["kernels"] for r in recs])
            out["mesh_collectives"] = alike(
                "collectives", [r["collectives"] for r in recs])
            out["mesh_storage"] = [r.get("storage") for r in recs]
            for rank, r in enumerate(recs):
                if not r.get("storage", {"ok": True})["ok"]:
                    errors.append(f"mesh storage identity, rank {rank}: "
                                  f"{r['storage']}")
                for name, m in r["mutants"].items():
                    if not m["ok"]:
                        errors.append(
                            f"mesh mutant self-test '{name}', rank {rank}: "
                            f"expected {m['expected']}, found {m['actual']}")
            out["mesh_mutants"] = {name: m for name, m
                                   in recs[0]["mutants"].items()}
    out["_mesh_unknown"] = sorted(set(out["_mesh_unknown"]))
    return out


# ---------------------------------------------------------------------------
# spawning a world
# ---------------------------------------------------------------------------

def _rank(rank, size, world, base, fn, device, args):
    torch.set_num_threads(1)
    import torch.distributed as dist
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if cuda else "gloo", store=dist.FileStore(os.path.join(base, "store"), size),
        rank=rank, world_size=size)
    code = 0
    try:
        try:
            rec = {"ok": fn(world, *args)}
        except Exception:                  # reported by the parent
            rec, code = {"error": traceback.format_exc()}, 1
        with open(os.path.join(base, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(rec, f)
        if not code:
            dist.barrier()      # no rank leaves while another still sends
    finally:
        dist.destroy_process_group()
    # leave without the interpreter's teardown: a gloo thread still
    # joinable there can abort a rank whose record is already written
    os._exit(code)


class Worlds:
    """Worlds of ranks started by :func:`start`; :meth:`gather` waits for
    them and returns their records."""

    def __init__(self, fn, worlds: Dict[str, int], device, args):
        import torch.multiprocessing as mp

        from repro_torch import resolve_device
        dev = resolve_device(device)
        if dev.type == "cuda" and \
                max(worlds.values()) > torch.cuda.device_count():
            raise ValueError(f"NCCL takes one rank a card: a world of "
                             f"{max(worlds.values())} ranks on "
                             f"{torch.cuda.device_count()} cards")
        self.sizes = dict(worlds)
        self.root = tempfile.mkdtemp(prefix="repro_torch_mesh_")
        self.ctxs = {}
        try:
            for world, size in worlds.items():
                base = os.path.join(self.root, world)
                os.makedirs(base)
                self.ctxs[world] = mp.start_processes(
                    _rank, args=(size, world, base, fn, str(dev), args),
                    nprocs=size, join=False, start_method="spawn")
        except BaseException:
            self.stop()
            raise

    def _records(self, world) -> List:
        recs = [None] * self.sizes[world]
        for r in range(self.sizes[world]):
            path = os.path.join(self.root, world, f"rank{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    recs[r] = pickle.load(f)
        for r, rec in enumerate(recs):      # a rank's error first
            if rec is not None and "error" in rec:
                raise RuntimeError(f"rank {r} of the {world} world "
                                   f"failed:\n{rec['error']}")
        for r, rec in enumerate(recs):
            if rec is None:
                raise RuntimeError(f"rank {r} of the {world} world left "
                                   f"no record")
        return [rec["ok"] for rec in recs]

    def gather(self, timeout: float = SPAWN_TIMEOUT) -> Dict[str, List]:
        """Each world's records by rank, once every rank has left.  A rank
        that raised, or a world past ``timeout`` seconds, raises here;
        every rank is stopped on the way out."""
        import torch.multiprocessing as mp
        try:
            deadline = time.monotonic() + timeout
            out = {}
            for world, ctx in self.ctxs.items():
                try:
                    while not ctx.join(timeout=1):
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                f"the {world} world did not finish within "
                                f"{timeout} s")
                except mp.ProcessExitedException:
                    pass                   # its records say why
                out[world] = self._records(world)
            return out
        finally:
            self.stop()

    def stop(self) -> None:
        """Stop every rank still running and remove the worlds' files."""
        for ctx in self.ctxs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        shutil.rmtree(self.root, ignore_errors=True)


def start(fn, worlds: Dict[str, int], *, device="cuda",
          args=()) -> Worlds:
    """Start every world of ``worlds`` (name -> ranks) at once, each rank
    a spawned process that calls ``fn(world name, *args)`` (a module-level
    function) on an initialised default process group of the world's
    size, and return at once: the caller may work while the ranks run,
    then calls :meth:`Worlds.gather`.  Gloo ranks for ``device="cpu"``,
    NCCL ranks, one a card, for ``device="cuda"``."""
    return Worlds(fn, worlds, device, args)


def spawn(fn, worlds: Dict[str, int], *, device="cuda", args=(),
          timeout: float = SPAWN_TIMEOUT) -> Dict[str, List]:
    """:func:`start` the worlds and :meth:`Worlds.gather` their records."""
    return start(fn, worlds, device=device, args=args).gather(timeout)


def run(quick: bool = False, device="cuda",
        timeout: float = SPAWN_TIMEOUT) -> dict:
    """Spawn the mesh stage's worlds, lint each rank, merge the records."""
    from repro_torch.analysis import entrypoints as ep
    worlds = {w: ep.MESH_WORLDS[w][0] for w in world_names(quick)}
    return merge(spawn(lint_world, worlds, device=device,
                       args=(quick, str(torch.device(device))),
                       timeout=timeout))
