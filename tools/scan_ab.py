#!/usr/bin/env python3
"""Time two builds of the ``selective_scan`` CUDA source side by side on one
card.

    git show REV:src/repro_torch/kernels/csrc/selective_scan.cu \\
        > build/ab/scan_base.cu
    python3 tools/scan_ab.py --baseline build/ab/scan_base.cu [--also X.cu ...]

Builds ``src/repro_torch/kernels/csrc/selective_scan.cu`` ("new"), the
baseline source ("base") and any further variants (named by their file
stem) into libraries under ``build/kernels/`` with ``vfl_grad_ab``'s
``build_all`` (the ``nvcc`` runs started together), and prints each build's
``-Xptxas -v`` summary and the registers and spills of each instance
(``--sass DIR`` also writes each library's ``cuobjdump -sass`` there and
prints, per build, the instruction mix of the N = 16 bf16 instance).
Then it holds each build against the plain version at the reference's
sweep shapes, a ragged shape and (4, 1024, 2048, 16), with mamba's a_log
and with a_log drawn per (channel, state), in f32 and bf16 (1e-4 and
5e-2, ``chip_smoke.SCAN_TOL``), checks that two calls of each build give
the same bits, and times the builds in turns (base, new, the variants,
then the same in reverse) with ``chip_smoke.py``'s CUDA-graph timer at
phase 9's prefill shape (4, 2048, 8192), N = 16, bf16, random a_log,
beside the bound.  All builds run in one process on one card, so their
times compare.  Needs a card; prints the card's name and power limit
first and a JSON summary last; writes the same to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402  (the timer and bound of the smoke run)
import vfl_grad_ab as ab  # noqa: E402  (build_all, SASS and turns)

SHAPES = [(1, 64, 128, 8), (2, 128, 256, 16), (1, 32, 512, 4),
          (3, 517, 1000, 16), (2, 37, 75, 8), (4, 1024, 2048, 16)]
PREFILL = (cs.LM_BATCH, cs.LM_PROMPT, 8192, 16)


def operands(torch, dev, gen, b, s, c, n, dtype, random_a):
    """chip_smoke's scan operands; a_log = log(1..N) in every channel or,
    with ``random_a``, log of uniform [0.5, 16] per (channel, state)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    xa = randn(b, s, c).to(dtype)
    dt = torch.nn.functional.softplus(randn(b, s, c))
    bm, cm = randn(b, s, n), randn(b, s, n)
    if random_a:
        a_log = torch.log(torch.rand((c, n), generator=gen, device=dev)
                          * 15.5 + 0.5)
    else:
        a_log = torch.log(torch.arange(1, n + 1, device=dev,
                                       dtype=torch.float32)).repeat(c, 1)
    return xa, dt, bm, cm, a_log, randn(c)


def sass_mix(text):
    """Opcode counts of the N = 16 bf16 instance in a build's SASS."""
    for fn in text.split("\tFunction : ")[1:]:
        head = fn.split("\n", 1)[0]
        if "Li16E" in head and "bfloat16" in head:
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", fn)
            return dict(Counter(op for op in ops).most_common())
    return {}


def clock_under_load(torch, fns, seconds=2.0):
    """{tag: (median SM clock MHz, median power W)} from nvidia-smi samples
    taken every 0.1 s while the build's call runs back to back."""
    import subprocess
    import threading
    import time
    out = {}
    for tag, fn in fns.items():
        samples, stop = [], threading.Event()

        def sample():
            while not stop.is_set():
                line = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=30).stdout.split(",")
                samples.append((float(line[0]), float(line[1])))
                time.sleep(0.1)

        fn()
        torch.cuda.synchronize()
        t = threading.Thread(target=sample)
        t.start()
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        stop.set()
        t.join()
        mhz = sorted(m for m, _ in samples)
        watts = sorted(w for _, w in samples)
        out[tag] = (mhz[len(mhz) // 2], watts[len(watts) // 2])
        cs.log(f"    {tag:14s} under load: SM clock {out[tag][0]:.0f} MHz, "
               f"power {out[tag][1]:.1f} W ({len(samples)} samples)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="the other selective_scan.cu to build and time")
    ap.add_argument("--also", type=Path, nargs="*", default=[],
                    help="further variants of selective_scan.cu")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "results" / "scan_ab.json")
    ap.add_argument("--sass", type=Path,
                    help="write each build's SASS here (cuobjdump -sass)")
    ap.add_argument("--clock", action="store_true",
                    help="sample the SM clock and power while each build "
                         "runs back to back for about 2 s")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("scan_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ss
    dev = torch.device("cuda")
    smi = ab.card_line()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    builds = {"base": ss.ScanKernel(), "new": ss.ScanKernel()}
    builds["base"].source = args.baseline.resolve()
    for path in args.also:
        builds[path.stem] = ss.ScanKernel()
        builds[path.stem].source = path.resolve()
    record = {"card": smi, "torch": torch.__version__,
              "baseline": str(args.baseline),
              "ptxas": ab.build_all(builds, ("selective_scan",)),
              "instances": {tag: cs._instances(lib.build_log,
                                               ("selective_scan",))
                            for tag, lib in builds.items()}}
    if args.sass is not None:
        ab.write_sass(builds, args.sass, "selective_scan")
        record["sass_mix"] = {
            tag: sass_mix((args.sass / f"{tag}.sass").read_text())
            for tag in builds}
        for tag, mix in record["sass_mix"].items():
            cs.log(f"{tag} N=16 bf16 SASS: {mix}")
    ok, rows = True, []
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    for shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for random_a in (False, True):
                ops = operands(torch, dev, gen, *shape, dtype, random_a)
                want = ref.selective_scan(*ops).float()
                tol = cs.SCAN_TOL[str(dtype).replace("torch.", "")]
                row = {"x": list(shape), "dtype": str(dtype),
                       "random_a": random_a}
                for tag, lib in builds.items():
                    y, again = lib.scan(*ops), lib.scan(*ops)
                    torch.cuda.synchronize()
                    err = float((y.float() - want).abs().max())
                    good = torch.allclose(y.float(), want, atol=tol,
                                          rtol=tol)
                    same = torch.equal(y, again)
                    row[f"{tag}_err"], row[f"{tag}_repeat_equal"] = err, same
                    ok &= good and same
                    if not (good and same):
                        cs.log(f"FAILED {tag} {shape} {dtype} random_a "
                               f"{random_a}: err {err} repeat-equal {same}")
                rows.append(row)
    cs.log(f"checked {len(rows)} cases against plain; all within tolerance "
           f"and repeatable: {ok}")
    ops = operands(torch, dev, gen, *PREFILL, torch.bfloat16, True)
    want = ref.selective_scan(*ops).float()
    fns = {}
    prefill = {"x": list(PREFILL), "dtype": "bfloat16", "random_a": True}
    for tag, lib in builds.items():
        y, again = lib.scan(*ops), lib.scan(*ops)
        torch.cuda.synchronize()
        err = float((y.float() - want).abs().max())
        good = torch.allclose(y.float(), want, atol=cs.SCAN_TOL["bfloat16"],
                              rtol=cs.SCAN_TOL["bfloat16"])
        same = torch.equal(y, again)
        prefill[f"{tag}_err"], prefill[f"{tag}_repeat_equal"] = err, same
        ok &= good and same
        fns[tag] = lambda lib=lib: lib.scan(*ops)
    order = list(builds) + list(builds)[::-1]
    times = ab.in_turns(torch, fns, order, reps=10, replays=5)
    clock, sms = cs._card_clock_and_sms(torch)
    b, s, c, n = PREFILL
    exps = b * s * c * n
    prefill["bound_exp_ms"] = exps / (cs.SFU_EXP_PER_CLOCK_PER_SM * sms
                                      * clock) * 1e3
    prefill["bound_bytes_ms"] = (cs._nbytes(*ops) + b * s * c * 2) \
        / cs.HBM_BYTES_PER_S * 1e3
    cs.log(f"prefill {PREFILL} bf16, random a_log: bound "
           f"{prefill['bound_exp_ms'] * 1e3:.2f} us (exponentials; bytes "
           f"{prefill['bound_bytes_ms'] * 1e3:.2f})")
    for tag, ts in times.items():
        prefill[f"{tag}_ms"] = ts
        cs.log(f"    {tag:14s} {sum(ts) / len(ts) * 1e3:9.2f} us "
               f"{[round(t * 1e3, 2) for t in ts]}  err "
               f"{prefill[f'{tag}_err']:.2e}  repeat-equal "
               f"{prefill[f'{tag}_repeat_equal']}")
    if args.clock:
        prefill["clock"] = clock_under_load(torch, fns)
    record.update(rows=rows, prefill=prefill, ok=ok)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    print(smi)
    print(json.dumps({"ok": ok, "prefill": {
        k: v for k, v in prefill.items() if k.endswith("ms")}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
