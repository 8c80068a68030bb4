#!/usr/bin/env python3
"""Drive the PyTorch port's secure serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one H100 (sm_90a) and the
CUDA toolkit; it needs no arguments and no network.  It imports nothing of
JAX or of the JAX package.

1. Set-up: the card's name and power limit, torch and CUDA versions; the
   hand-written CUDA kernel is built from ``src/repro_torch/kernels/csrc``
   into ``build/kernels/`` (git-ignored) and the build time printed.
2. Kernel phase: ``vfl_grad`` forward against its plain PyTorch version on
   the card at the serving shapes, a ragged shape and bf16 (atol = rtol =
   1e-4); kernel, plain and ``torch.matmul`` times from CUDA events over
   CUDA-graph replays, beside the byte/FLOP bound.
3. Linear serving at q=8 parties, m=2, d=4096 (dp=512 per party),
   n=350,000 samples (webspam's sample count at the repo's widest split),
   ``secure="two_tree"``, ``max_batch=64``: a cold pass over the whole
   universe, a Zipf warm trace of 1e5 requests (all hits), one weight
   update and a delta pass over the hot ids, checked against a float64
   reference on the card; then threads submit through ``ServeQueue`` and
   every result must equal ``ServeEngine.serve`` on the same ids.
4. Short cold-then-hit passes with ``secure="off"`` and ``"ring"``.
5. Deep serving (hidden=32, d_rep=16) over a subset, cold then hits,
   against a float64 plain encoder.
6. A torch.profiler window: the device busy share of cold and hit
   dispatches.

The source holds two kernel programs: ``vfl_forward_narrow`` (M <= 4, the
linear path) and ``vfl_forward_wide`` (the deep encoder layers).  Their
launch counters are reset just before phase 3 and read after phase 5;
each must be non-zero and equal the count the dispatch structure implies
(narrow: linear full and delta 2, linear hit 1; wide: deep full 4, deep
hit 2).  The ``kernels`` line has one entry per program, timed at its
main-path shape (linear full and deep layer 1).  Any failed check exits
non-zero.  The last three lines are the card's name and power limit, the
``kernels`` JSON line and ``{"ok": true, "device": {...}}``.  Details go
to ``results/chip_smoke.json`` (git-ignored).
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
SEED = 0
BATCH = 64                       # max_batch: requests per dispatch


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _graph_ms(torch, fn, reps=50, replays=20):
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events (no host gaps)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _bound(x, w, z, m):
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + z.numel() * z.element_size())
    flops = 2.0 * x.numel() * m
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOP_PER_S * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops
            else "operations", nbytes)


def kernel_phase(torch, dev):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import vfl_grad as vg
    # (name, party axis P or None, rows B, width D, columns M or None, dtype)
    shapes = [
        ("linear_full", 8, 64, 512, None, torch.float32),
        ("linear_hit", None, 64, 512, None, torch.float32),
        ("deep_layer1", 8, 64, 512, 32, torch.float32),
        ("deep_layer2", 8, 64, 32, 16, torch.float32),
        ("ragged_narrow", 3, 37, 333, 3, torch.float32),
        ("ragged_wide", 3, 37, 333, 21, torch.float32),
        ("linear_full_bf16", 8, 64, 512, None, torch.bfloat16),
        ("deep_layer1_bf16", 8, 64, 512, 32, torch.bfloat16),
    ]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for name, p, b, d, m, dtype in shapes:
        xshape = (b, d) if p is None else (p, b, d)
        wshape = (d,) if m is None else (d, m)
        wshape = wshape if p is None else (p,) + wshape
        x = torch.randn(xshape, generator=gen, device=dev).to(dtype)
        w = torch.randn(wshape, generator=gen, device=dev).to(dtype)
        z = ops.vfl_grad(x, w, mode="forward")[0]
        zr = ref.vfl_forward_ref(x, w)
        torch.cuda.synchronize()
        err = float((z - zr).abs().max())
        check(tuple(z.shape) == tuple(zr.shape) and z.dtype == torch.float32,
              f"kernel {name}: shape/dtype {tuple(z.shape)} {z.dtype}")
        check(torch.allclose(z, zr, atol=1e-4, rtol=1e-4),
              f"kernel {name}: max abs err {err} beyond 1e-4")
        wcol = w if m is not None else w.unsqueeze(-1)
        kernel_ms = _graph_ms(torch, lambda: ops.vfl_grad(x, w)[0])
        plain_ms = _graph_ms(torch, lambda: ref.vfl_forward_ref(x, w))
        library_ms = _graph_ms(torch, lambda: torch.matmul(x, wcol))
        bound_ms, bound_by, nbytes = _bound(x, w, z, 1 if m is None else m)
        program = vg.PROGRAMS[0] if (m or 1) <= vg.NARROW_MAX_M \
            else vg.PROGRAMS[1]
        rows.append(dict(name=name, program=program, x=list(xshape),
                         w=list(wshape),
                         dtype=str(dtype).replace("torch.", ""),
                         max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes))
        log(f"{program} {name:18s} x{list(xshape)} w{list(wshape)} "
            f"{rows[-1]['dtype']}: err {err:.3e}  kernel {kernel_ms*1e3:.2f} "
            f"us  plain {plain_ms*1e3:.2f} us  matmul {library_ms*1e3:.2f} "
            f"us  bound {bound_ms*1e3:.3f} us ({bound_by})")
    return rows


# ---------------------------------------------------------------------------
# serving phases
# ---------------------------------------------------------------------------

def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _serve_chunks(sv, ids):
    """Serve ``ids`` in BATCH-request chunks; returns (predictions,
    per-chunk host latencies in ms).  ``serve`` returns host numpy, so each
    latency ends after the device finished."""
    out = np.empty(ids.shape[0], np.float32)
    lat = []
    for lo in range(0, ids.shape[0], BATCH):
        t0 = time.perf_counter()
        out[lo:lo + BATCH] = sv.serve(ids[lo:lo + BATCH])
        lat.append((time.perf_counter() - t0) * 1e3)
    return out, lat


def _close(got, want, tol, what):
    want = want.cpu().numpy() if hasattr(want, "cpu") else want
    err = np.abs(got.astype(np.float64) - want)
    bad = err > tol + tol * np.abs(want)
    check(not bad.any(), f"{what}: {int(bad.sum())} predictions beyond "
          f"{tol} of the float64 reference (max abs err {err.max():.3e})")
    return float(err.max())


def _linear_ref(torch, x, w, ids):
    """float64 x[ids] @ w on the card, in slices."""
    idt = torch.as_tensor(ids, device=x.device)
    out = []
    for lo in range(0, idt.shape[0], 32768):
        out.append(x[idt[lo:lo + 32768]].double() @ w.double())
    return torch.cat(out)


def _latency(lat, count):
    total_s = sum(lat) / 1e3
    return dict(chunks=len(lat), p50_ms=pct(lat, 50), p90_ms=pct(lat, 90),
                p99_ms=pct(lat, 99), requests_per_s=count / total_s,
                seconds=total_s)


def _zipf_ids(n, count, seed, s=1.0):
    """``count`` draws from a Zipf(s) over ranks 1..n, ranks mapped to a
    random permutation of the ids so the hot set is scattered."""
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(1.0 / np.arange(1, n + 1) ** s)
    ranks = np.searchsorted(cdf / cdf[-1], rng.random(count))
    return rng.permutation(n)[np.minimum(ranks, n - 1)]


def _serve_engine(torch, dev, x, layout, secure, y=None):
    """A FusedEngine over the universe ``x`` and a ServeEngine on it."""
    from repro_torch.core.engine import EngineConfig, FusedEngine
    from repro_torch.core.losses import logistic_l2
    from repro_torch.serve import ServeEngine
    y = torch.ones(x.shape[0], device=dev) if y is None else y
    eng = FusedEngine(logistic_l2(1e-4), x, y, layout,
                      EngineConfig(secure=secure), device=dev)
    return ServeEngine(eng, max_batch=BATCH, seed=SEED, device=dev)


def expected_launches(sv):
    """Launches per kernel program implied by ``sv``'s dispatches: the
    linear path (M=1) runs the narrow program, the deep encoder layers
    (M=32, 16) the wide one."""
    st = sv.stats
    if sv.deep:
        return Counter(vfl_forward_wide=4 * st.full_dispatches
                       + 2 * st.hit_dispatches)
    return Counter(vfl_forward_narrow=2 * (st.full_dispatches
                                           + st.delta_dispatches)
                   + st.hit_dispatches)


def linear_phase(torch, dev, x, layout, *, trace_len, hot_len, log_):
    """two_tree serving at full size: cold → Zipf hits → update → delta →
    queue.  Returns (metrics, expected launches)."""
    n, d = x.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    y = torch.where(torch.randn(n, generator=gen, device=dev) > 0, 1.0, -1.0)
    sv = _serve_engine(torch, dev, x, layout, "two_tree", y)
    w0 = torch.randn(d, generator=gen, device=dev) / d ** 0.5
    sv.set_weights(w0)
    res = {}

    all_ids = np.arange(n)
    cold, lat = _serve_chunks(sv, all_ids)
    res["cold"] = _latency(lat, n)
    res["cold"]["max_abs_err"] = _close(
        cold, _linear_ref(torch, x, w0, all_ids), 1e-4, "linear cold")
    check(sv.stats.full_dispatches == -(-n // BATCH), "cold routing")
    log_(f"linear cold: {res['cold']}")

    trace = _zipf_ids(n, trace_len, SEED + 2)
    hits0 = sv.stats.hit_dispatches
    warm, lat = _serve_chunks(sv, trace)
    res["warm"] = _latency(lat, trace_len)
    check(sv.stats.hit_dispatches - hits0 == -(-trace_len // BATCH),
          "warm trace must be all hits")
    check(np.array_equal(warm, cold[trace]),
          "warm hits are not bit-exact against the cold values")
    res["warm"]["distinct_ids"] = int(np.unique(trace).shape[0])
    log_(f"linear warm (Zipf, all hits, bit-exact): {res['warm']}")

    _, first = np.unique(trace, return_index=True)
    hot = trace[np.sort(first)][:hot_len]
    w1 = w0 + 0.01 * torch.randn(d, generator=gen, device=dev) / d ** 0.5
    sv.set_weights(w1)
    delta0 = sv.stats.delta_dispatches
    refreshed, lat = _serve_chunks(sv, hot)
    res["delta"] = _latency(lat, hot.shape[0])
    check(sv.stats.delta_dispatches - delta0 == -(-hot.shape[0] // BATCH),
          "one-version-stale entries must route through delta")
    res["delta"]["max_abs_err"] = _close(
        refreshed, _linear_ref(torch, x, w1, hot), 1e-4,
        "linear delta")
    again, _ = _serve_chunks(sv, hot)
    check(np.array_equal(again, refreshed),
          "repaired entries must re-serve bit-exactly")
    log_(f"linear delta: {res['delta']}")

    res["queue"] = queue_phase(sv, trace)
    res["queue"]["max_abs_err"] = _close(
        sv.serve(trace[:4096]),
        _linear_ref(torch, x, w1, trace[:4096]), 1e-4, "queue")
    log_(f"queue: {res['queue']}")
    res["stats"] = dict(vars(sv.stats))
    return res, expected_launches(sv)


def queue_phase(sv, trace, threads=8, per_thread=48):
    """Concurrent clients through ServeQueue; each result must equal
    ``sv.serve`` on the same ids afterwards."""
    from repro_torch.serve import ServeQueue
    rng = np.random.default_rng(SEED + 3)
    jobs = [[trace[rng.integers(0, trace.shape[0], size=rng.integers(1, 5))]
             for _ in range(per_thread)] for _ in range(threads)]
    results = [[] for _ in range(threads)]
    errors = []

    def client(i):
        try:
            for ids in jobs[i]:
                results[i].append(q.serve(ids, timeout=60.0))
        except Exception as e:              # relayed to the main thread
            errors.append(e)

    t0 = time.perf_counter()
    with ServeQueue(sv, max_wait=0.002) as q:
        pool = [threading.Thread(target=client, args=(i,))
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(120.0)
            check(not t.is_alive(), "queue client did not finish")
    seconds = time.perf_counter() - t0
    check(not errors, f"queue clients failed: {errors[:1]}")
    nreq = 0
    for i in range(threads):
        for ids, got in zip(jobs[i], results[i]):
            check(np.array_equal(got, sv.serve(ids)),
                  "queue result differs from ServeEngine.serve")
            nreq += ids.shape[0]
    return dict(requests=nreq, submits=threads * per_thread,
                batches=q.coalesced_batches, seconds=seconds)


def secure_pass(torch, dev, x, layout, secure, count):
    """A short cold-then-hit pass under another secure mode."""
    n, d = x.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    sv = _serve_engine(torch, dev, x, layout, secure)
    w = torch.randn(d, generator=gen, device=dev) / d ** 0.5
    sv.set_weights(w)
    ids = np.random.default_rng(SEED + 5).permutation(n)[:count]
    cold, lat = _serve_chunks(sv, ids)
    res = _latency(lat, count)
    res["max_abs_err"] = _close(cold, _linear_ref(torch, x, w, ids),
                                1e-4, f"linear {secure}")
    hit, _ = _serve_chunks(sv, ids)
    check(np.array_equal(hit, cold), f"{secure}: hits not bit-exact")
    return res, expected_launches(sv)


def deep_phase(torch, dev, x, layout, count):
    """Deep serving (hidden=32, d_rep=16) cold then hits over a subset,
    against a float64 plain encoder on the card."""
    from repro_torch.core.deep_vfl import init_deep_vfl
    n, d = x.shape
    sv = _serve_engine(torch, dev, x, layout, "two_tree")
    params = init_deep_vfl(torch.Generator(device=dev).manual_seed(SEED + 6),
                           layout, d, hidden=32, d_rep=16)
    sv.set_deep_params(params)
    ids = np.random.default_rng(SEED + 7).permutation(n)[:count]
    cold, lat = _serve_chunks(sv, ids)
    res = {"cold": _latency(lat, count)}
    idt = torch.as_tensor(ids, device=dev)
    z = 0
    for (lo, hi), w1, b1, w2 in zip(layout.bounds, params.enc_w1,
                                    params.enc_b1, params.enc_w2):
        xb = x[idt, lo:hi].double()
        z = z + torch.tanh(xb @ w1.double() + b1.double()) @ w2.double()
    res["cold"]["max_abs_err"] = _close(cold, z @ params.head.double(),
                                        1e-4, "deep cold")
    hit, lat = _serve_chunks(sv, ids)
    res["hit"] = _latency(lat, count)
    check(np.array_equal(hit, cold), "deep hits not bit-exact vs cold")
    check(sv.stats.hit_dispatches == -(-count // BATCH), "deep hit routing")
    res["stats"] = dict(vars(sv.stats))
    return res, expected_launches(sv)


def profile_window(torch, dev, x, layout, chunks=200):
    """Device busy share over ``chunks`` cold two_tree dispatches and then
    the same ids again as hits, from torch.profiler (None where the
    profiler records no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sv = _serve_engine(torch, dev, x, layout, "two_tree")
    sv.set_weights(torch.ones(x.shape[1], device=dev) / x.shape[1])
    _serve_chunks(sv, np.arange(BATCH))            # warm the path
    sel = np.arange(BATCH, (chunks + 1) * BATCH)
    out = {}
    for label in ("cold_full", "hit"):             # same ids: then all hits
        _sync(torch, dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _serve_chunks(sv, sel)
            _sync(torch, dev)
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = {}          # device activities only: kernels and copies
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                kernels[ev.key] = kernels.get(ev.key, 0.0) \
                    + ev.self_device_time_total
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        out[label] = dict(
            dispatches=sel.shape[0] // BATCH, wall_us=wall_us,
            device_busy_us=busy,
            device_busy_share=(busy / wall_us) if busy > 0 else None,
            top_device_us=[[k[:80], v] for k, v in top])
        log(f"profile {label}: {out[label]}")
    return out, expected_launches(sv)


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.algorithms import PartyLayout
    from repro_torch.kernels import vfl_grad as vg

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 references
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    vg.KERNEL.library()
    log(f"kernel build+load: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {vg.KERNEL.build_seconds} s)")
    log(vg.KERNEL.build_log.strip())

    record = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    record["kernel_shapes"] = kernel_phase(torch, dev)

    q, m_act, d, n = 8, 2, 4096, 350_000
    layout = PartyLayout.even(d, q, m_act)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((n, d), generator=gen, device=dev)      # ~5.7 GB
    torch.cuda.reset_peak_memory_stats()

    vg.KERNEL.reset_launches()                      # the main path starts
    expected = Counter()
    record["linear_two_tree"], e = linear_phase(
        torch, dev, x, layout, trace_len=100_000, hot_len=8192, log_=log)
    expected += e
    for secure in ("off", "ring"):
        record[f"linear_{secure}"], e = secure_pass(
            torch, dev, x, layout, secure, count=BATCH * 100)
        expected += e
        log(f"linear {secure}: {record[f'linear_{secure}']}")
    record["deep_two_tree"], e = deep_phase(torch, dev, x, layout,
                                            count=BATCH * 300)
    expected += e
    log(f"deep: {record['deep_two_tree']}")
    launches = dict(vg.KERNEL.launches)             # the main path ends
    check(launches == {p: expected[p] for p in vg.PROGRAMS},
          f"kernel launches {launches} != {dict(expected)} implied by "
          "dispatches")
    check(all(launches.values()),
          f"a kernel of the path was never launched: {launches}")
    log(f"main path: kernel launches {launches}, as the dispatches imply")
    record["main_path_launches"] = launches
    record["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

    record["profile"], _ = profile_window(torch, dev, x, layout)
    record["seconds"] = time.perf_counter() - t_start

    # each program's line reports its own main-path shape: the linear full
    # dispatch for the narrow program, deep layer 1 for the wide one
    main_shape = {"vfl_forward_narrow": "linear_full",
                  "vfl_forward_wide": "deep_layer1"}
    entries = []
    for prog in vg.PROGRAMS:
        row = next(r for r in record["kernel_shapes"]
                   if r["name"] == main_shape[prog])
        entries.append({
            "name": prog, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/vfl_grad.cu",
            "replaces": "src/repro/kernels/vfl_grad.py:343",
            "launches": launches[prog],
            "max_abs_err": max(r["max_abs_err"] for r in
                               record["kernel_shapes"]
                               if r["program"] == prog),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    kernels = {"kernels": entries}
    out_dir = ROOT / "results"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"total {record['seconds']:.1f} s; details in "
        "results/chip_smoke.json")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
