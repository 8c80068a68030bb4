#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s later phases alone on one card.

    python3 tools/chip_phases.py 10 15 16 17 18 19 20 21 22 23 24 [--out PATH]

Builds the kernel libraries the named phases launch, makes phase 7's
resident data on the card (x (350000, 4096) f32 from the seed, the D4
labels) where a phase of 14-18 needs it, and runs the named phases'
functions of ``chip_smoke.py`` (14: faults, 15: deep faults, 16: the
party mesh, 17: serving over the mesh and the thread simulation, 18: the
linter on the card, 19: LM training, 20: MoE serving, 21: hybrid
serving, 22: cross attention and the secure frontends, 23: the dry run
against the card, 24: the device party mesh in spawned ranks, which make
their own data; 19-24 need no resident data),
each with its kernel counters set to 0 just before it, its hard checks as
in the script, and every log line stamped with the seconds since the
first phase began.  Phase 10 (dense serving, gemma3-4b whole) runs too,
needing no resident data either.  It prints each phase's launches
beside what its steps imply, its seconds and its peak device memory, and
writes the phases' records to ``--out``.  A phase's checks here are the
script's; its time here is that of the phase alone, without the phases
that run before it in the script.  Needs a card; prints the card's name
and power limit first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.core.algorithms import PartyLayout
    from repro_torch.kernels import vfl_grad as vg

    ap = argparse.ArgumentParser()
    ap.add_argument("phases", nargs="+",
                    choices=("10", "14", "15", "16", "17", "18", "19",
                             "20", "21", "22", "23", "24"))
    ap.add_argument("--out", default="chiprun_out/phases.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    lm = {"10", "19", "20", "21", "22", "23"}
    vfl = [p for p in args.phases if p not in lm]
    resident = [p for p in vfl if p != "24"]
    # vfl_grad for phases 14-18 and 24; the scan and flash attention for
    # 19; both attention kernels for 10, 20 and 22; all three LM kernels
    # for 21, 23
    libs = cs._libs()
    libs = (list(libs[:1]) if vfl else []) \
        + (list(libs[1:2]) if {"19", "21", "23"} & set(args.phases)
           else []) \
        + (list(libs[2:3]) if lm & set(args.phases) else []) \
        + (list(libs[3:]) if {"10", "20", "21", "22", "23"}
           & set(args.phases) else [])
    t0 = time.perf_counter()
    threads = [threading.Thread(target=lib.library) for lib in libs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for lib in libs:
        lib.library()              # raises here if its build failed
    cs.log(f"{[lib.source.name for lib in libs]} built in "
           f"{time.perf_counter() - t0:.1f} s")
    layout = PartyLayout.even(cs.D, cs.Q, cs.M_ACT)
    x = y = None
    if resident:
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        x = torch.randn((cs.N, cs.D), generator=gen, device=dev)
        y = cs.d4_labels(torch, dev, x)
    start = time.perf_counter()

    def log(*a):
        print(f"[{time.perf_counter() - start:7.1f}]", *a, flush=True)

    phases = {"14": lambda: cs.fault_phase(torch, dev, x, y, layout, log),
              "15": lambda: cs.deep_fault_phase(torch, dev, x, y, layout,
                                                log),
              "16": lambda: cs.mesh_phase(torch, dev, x, y, log),
              "17": lambda: cs.serve_async_phase(torch, dev, x, y, log),
              "18": lambda: cs.lint_phase(torch, dev, x, y, layout, log)}
    out = {}
    for name in args.phases:
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cs.reset_counts()
        if name == "24":
            # its checks and launch counts run inside the phase, in ranks
            res, launches = cs.dist_phase(torch, dev, log)
            res["seconds"] = time.perf_counter() - t
            log(f"phase 24: device-mesh launches {launches}; "
                f"{res['seconds']:.1f} s")
            out[name] = res
            continue
        if name in lm:
            # their checks (launches included) run inside the phase
            run = {"10": cs.dense_phase, "19": cs.lm_train_phase,
                   "20": cs.moe_phase,
                   "21": cs.hybrid_phase, "22": cs.frontend_phase,
                   "23": cs.dry_phase}[name]
            res, launches = run(torch, dev, log)
            res["seconds"] = time.perf_counter() - t
            res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            log(f"phase {name}: launches {launches}; "
                f"{res['seconds']:.1f} s")
            out[name] = res
            continue
        res, expected = phases[name]()
        # phase 18 reads its path's counts before its dispatch timing
        got = res.pop("launches", None) or dict(vg.KERNEL.launches)
        cs.check(got == {p: expected[p] for p in vg.PROGRAMS},
                 f"phase {name} launches {got} != {dict(expected)}")
        res["seconds"] = time.perf_counter() - t
        res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"phase {name}: launches {got}, as the steps imply; "
            f"{res['seconds']:.1f} s, peak {res['peak_memory_gb']:.1f} GB")
        out[name] = res
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
