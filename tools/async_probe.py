#!/usr/bin/env python3
"""What paces the BAPA thread simulation (``core/async_engine.py``) on one
card.

    python3 tools/async_probe.py [--src DIR] [--rate] [--out PATH]

On ``chip_smoke.py``'s phase 7 data (x (350000, 4096) f32 from the seed,
the D4 labels) at phase 17's regime (q = 8, m = 3, 3 threads a party, the
last party 1.45x slower, ``base_delay`` 2 ms, batch 32, 1,000 dominator
iterations), it runs ``run_sync`` and then ``run_async`` (secure) and
prints their wall times, their ratio and the host seconds a dominator
iteration.  With ``--rate`` it also runs a collaborator's update
(``_apply_update``, lr 0, each thread calling torch itself, without the
run's launcher thread) back to back for one second in 1, 3 and 24
threads at the runs' switch interval, and measures the overshoot of a
2 ms ``time.sleep``: updates/s and host µs an update.

``--src`` imports the port from another tree's ``src`` (a ``git
archive`` of an earlier commit unpacked under ``build/``), so that two
versions can be compared on one card: run parent, change, change,
parent.  Needs a card; prints the card's name and power limit first.
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
RATE_THREADS = (1, 3, 24)


def _rate(torch, ae, dev, x, lay, prob, batch, seed):
    """Updates/s of ``_apply_update`` in 1, 3 and 24 threads, and a 2 ms
    sleep's overshoot."""
    from chip_smoke import ASYNC_DELAY, pct
    from repro_torch.core.engine import pack_features
    over = []
    for _ in range(200):
        t0 = time.perf_counter()
        time.sleep(ASYNC_DELAY)
        over.append((time.perf_counter() - t0 - ASYNC_DELAY) * 1e6)
    out = {"sleep_2ms_overshoot_us": dict(p50=pct(over, 50),
                                          p99=pct(over, 99))}
    xs = pack_features(x, lay, dev)
    xsp = xs.split(1)
    shared = ae._Shared(xs.shape[2], lay, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    theta = torch.randn((1, batch, 1), generator=gen, device=dev)
    ib = torch.randint(0, x.shape[0], (batch,), generator=gen, device=dev)
    sys.setswitchinterval(0.0005)
    for k in RATE_THREADS:
        counts, stop = [0] * k, threading.Event()

        def body(i):
            while not stop.is_set():
                ae._apply_update(prob, xsp, shared, i % lay.q, theta, ib,
                                 0.0)
                counts[i] += 1

        pool = [threading.Thread(target=body, args=(i,)) for i in range(k)]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for t in pool:
            t.start()
        time.sleep(1.0)
        stop.set()
        for t in pool:
            t.join()
        torch.cuda.synchronize(dev)
        rate = sum(counts) / (time.perf_counter() - t0)
        out[f"threads_{k}"] = dict(updates_per_s=rate,
                                   host_us_per_update=1e6 / rate)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--rate", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import async_engine as ae
    from repro_torch.core.algorithms import PartyLayout
    from repro_torch.core.losses import logistic_l2
    from repro_torch.kernels import vfl_grad as vg
    if not torch.cuda.is_available():
        print("async_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"port from {ae.__file__}", flush=True)
    interval = sys.getswitchinterval()
    dev = torch.device("cuda")
    vg.KERNEL.library()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    x = torch.randn((cs.N, cs.D), generator=gen, device=dev)
    y = cs.d4_labels(torch, dev, x)
    n, d = x.shape
    lay = PartyLayout.even(d, cs.Q, cs.ASYNC_M)
    prob, batch = logistic_l2(1e-4), cs.TRAIN_BATCH
    speeds = [1.0] * lay.q
    speeds[-1] = cs.ASYNC_STRAGGLER
    kw = dict(lr=cs.TRAIN_LR, batch=batch,
              total_epochs=cs.ASYNC_ITERS * batch / n,
              speed_factors=speeds, base_delay=cs.ASYNC_DELAY, seed=cs.SEED,
              device=dev)
    s = ae.run_sync(prob, x, y, lay, **kw)
    torch.cuda.synchronize(dev)
    a = ae.run_async(prob, x, y, lay, secure=True,
                     threads_per_party=cs.ASYNC_THREADS,
                     max_wall=cs.ASYNC_MAX_WALL, **kw)
    torch.cuda.synchronize(dev)
    iters = getattr(a, "iterations", 0) or a.updates / lay.q
    rec = dict(src=args.src, sync_s=s.wall_time, async_s=a.wall_time,
               sync_over_async=s.wall_time / a.wall_time,
               async_host_s_per_iteration=a.wall_time / iters,
               async_updates=a.updates, async_iterations=iters,
               timed_out=a.timed_out,
               objective=[a.loss_trace[0][2], a.loss_trace[-1][2]],
               finite=bool(np.all(np.isfinite(a.w))))
    print(f"async_probe run: {rec}", flush=True)
    if args.rate:
        rec["rate"] = _rate(torch, ae, dev, x, lay, prob, batch, cs.SEED)
        print(f"async_probe rate: {rec['rate']}", flush=True)
    sys.setswitchinterval(interval)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
