#!/usr/bin/env python3
"""Time two builds of the ``vfl_grad`` CUDA source side by side on one card.

    git show REV:src/repro_torch/kernels/csrc/vfl_grad.cu > build/ab/base.cu
    python3 tools/vfl_grad_ab.py --baseline build/ab/base.cu [--also X.cu ...]

Builds ``src/repro_torch/kernels/csrc/vfl_grad.cu`` ("new"), the
baseline source ("base") and any further variants (named by their file
stem) into libraries under ``build/kernels/`` (the ``nvcc`` runs started
together) and prints each build's ``-Xptxas -v`` summary (``--sass DIR``
also writes each library's ``cuobjdump -sass`` there).  Then, at the
main-path shapes of ``chip_smoke.py``, it holds each build against the
plain version (atol = rtol = 1e-4), checks that two calls of each build
agree bit for bit and that every build gives the same g bit for bit at
every backward, reduce and fused shape, and times the builds in turns
(base, new, the variants, then the same in reverse) with
``chip_smoke.py``'s CUDA-graph timer, beside the one PyTorch call that
computes the same function where there is one and, once, a one-element
fill as the timer's floor for a launch.  The shapes: the narrow
forward's (serving's full dispatch (8, 64, 512)·1 in f32 and bf16 and
its cache-hit dispatch (64, 512), the SGD step's (8, 32, 512)·1,
SVRG's ·2, the multi-dominator step's (8, 64, 512)·1, the full-dataset
pass (8, 350000, 512)·1 beside cuBLAS ``matmul``), the backward
programs' (the SGD step's rows, which is the noise yardstick when a
change leaves the backward alone, then the SVRG, SAGA and
multi-dominator steps, the full-dataset backward and its reduce) and
the four pipelined steps' ``vfl_fused_split``; and deep training's
(``chip_smoke.py`` phase 12: hidden 32, d_rep 16): the wide forward's
layer 1 (8, 32, 512)·32, SVRG's ·64 and the multi-dominator SVRG's
(8, 64, 512)·64, layer 2 (8, 32, 32)·16, the rows backward per party at
Mθ = 32 and 64 and shared at Mθ = 16, the split steps at Mw = Mθ = 32
and 64, and ``deep_full_gradient``'s passes over all n rows (the wide
forward ·32 and its backward with the reduce, layer 2's forward and
backward); and phase 13's per-dominator steps over the m = 2 dominators'
block-diagonal columns: the rows backward (8, 64, 512) at Mθ = 64 per
party and (8, 64, 32) at a shared Mθ = 32, and the split step
(8, 64+64, 512) at Mw = 32, Mθ = 64.  All builds run in one
process on one card, so their times compare.  Last, end to end, with
``vfl_grad.KERNEL`` set to each build in the same turns: one SGD and one
pipelined SGD epoch of ``chip_smoke.py``'s phase 7 (q = 8, d = 4096, n =
350,000, batch 32, ``two_tree``) through the port's engine, timed per
step on the host clock (the step graph captured first, the timed run
synchronised at both ends) and, in a profiler window over one more run,
each ``vfl_grad`` program's device time per step; and the full-gradient
pass (CUDA events over 20 passes). Needs a card; prints the card's name
and power limit first and a JSON summary last; writes the same to
``--out``.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402  (the timer and bound of the smoke run)

TOL = dict(atol=1e-4, rtol=1e-4)


def cases(torch, dev):
    """(name, kind, operands, plain, library, bytes, flops, big): kind is
    ``forward``, ``backward``, ``reduce`` or ``fused`` and says which
    ``CudaKernel`` method runs the operands."""
    from repro_torch.core.engine import dom_block_cols
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, dp, b, n = cs.Q, cs.D // cs.Q, cs.TRAIN_BATCH, cs.N
    out = []

    def forward(name, p, rows, m, dtype=torch.float32, d=dp, big=False):
        x = randn(p, rows, d, dtype=dtype)
        w = randn(p, d, m, dtype=dtype)
        out.append((name, "forward", (x, w),
                    lambda x=x, w=w: ref.vfl_forward_ref(x, w),
                    lambda x=x, w=w: torch.matmul(x, w),
                    cs._nbytes(x, w) + p * rows * m * 4,
                    2.0 * x.numel() * m, big))

    # the narrow forward at its step shapes, then the wide forward at deep
    # serving's: (name, P, rows, M, dtype, D)
    for args in (("linear_full", q, 2 * b, 1),
                 ("linear_full_bf16", q, 2 * b, 1, torch.bfloat16),
                 ("linear_hit", 1, 2 * b, 1),
                 ("train_step_forward", q, b, 1),
                 ("train_svrg_forward", q, b, 2),
                 ("train_multi_forward", q, cs.M_ACT * b, 1),
                 ("deep_layer1", q, 2 * b, 32),
                 ("deep_layer1_bf16", q, 2 * b, 32, torch.bfloat16),
                 ("deep_layer2", q, 2 * b, 16, torch.float32, 32),
                 ("deep_hit", 1, 2 * b, 32),
                 ("deep_hit_layer2", 1, 2 * b, 16, torch.float32, 32),
                 # deep training's steps (multi: deep_layer1's shape)
                 ("deep_train_layer1", q, b, 32),
                 ("deep_train_layer2", q, b, 16, torch.float32, 32),
                 ("deep_svrg_layer1", q, b, 64),
                 ("deep_multi_svrg_layer1", q, 2 * b, 64)):
        forward(*args)
    # backward steps: (name, rows, M, ϑ shared, denom, D, dominators: Θ
    # block-diagonal over them (dom_block_cols), or 0); the first is the
    # yardstick of a change to the forward
    for name, rows, m, shared, denom, d, doms in (
            ("train_sgd_step", b, 1, True, b, dp, 0),
            ("train_svrg_step", b, 2, True, b, dp, 0),
            ("train_saga_step", b, 1, False, 1, dp, 0),
            ("train_multi_step", 2 * b, 2, True, b, dp, 2),
            # deep training's xᵀ∂u (per party) and hᵀϑ_z (shared)
            ("deep_w1_step", b, 32, False, 1, dp, 0),
            ("deep_svrg_w1_step", b, 64, False, 1, dp, 0),
            ("deep_multi_w1_step", 2 * b, 32, False, 1, dp, 0),
            ("deep_w2_step", b, 16, True, 1, 32, 0),
            # the multi delayed deep step's per-dominator slabs
            ("deep_dom_w1_step", 2 * b, 64, False, 1, dp, 2),
            ("deep_dom_w2_step", 2 * b, 32, True, 1, 32, 2)):
        x = randn(q, rows, d)
        tail = m // doms if doms else m
        th = randn(rows, tail) if shared else randn(q, rows, tail)
        if doms:
            th = dom_block_cols(th, doms)
        thq = th.expand(q, rows, m) if shared else th
        zeros = torch.zeros((q, d, m), device=dev)
        out.append((name, "backward", (x, thq, None, 0.0, float(denom)),
                    lambda x=x, thq=thq, d=denom: ref.vfl_backward_ref(
                        x, thq, None, 0.0, d),
                    lambda x=x, thq=thq, z=zeros, d=denom: torch.baddbmm(
                        z, x.transpose(1, 2), thq, beta=0.0, alpha=1.0 / d),
                    cs._nbytes(x, thq) + zeros.numel() * 4,
                    2.0 * x.numel() * m, False))
    # pipelined steps: (name, Bb = Bf, Mw, Mθ, ϑ shared, denom,
    # dominators of a block-diagonal Θ or 0)
    for name, bb, mw, mth, shared, denom, doms in (
            ("pipe_sgd_step", b, 1, 1, True, b, 0),
            ("pipe_svrg_step", b, 2, 2, True, b, 0),
            ("pipe_saga_step", b, 1, 1, False, 1, 0),
            ("multi_pipe_sgd_step", 2 * b, 1, 2, True, b, 2),
            # deep training's: per-party ∂u beside layer 1's forward
            ("deep_pipe_sgd_step", b, 32, 32, False, 1, 0),
            ("deep_pipe_svrg_step", b, 64, 64, False, 1, 0),
            ("deep_multi_pipe_sgd_step", 2 * b, 32, 32, False, 1, 0),
            # the multi pipelined delayed one: per-dominator ∂u slabs
            ("deep_dom_pipe_step", 2 * b, 32, 64, False, 1, 2)):
        x = randn(q, 2 * bb, dp)
        w = randn(q, dp, mw)
        tail = mth // doms if doms else mth
        th = randn(bb, tail) if shared else randn(q, bb, tail)
        if doms:
            th = dom_block_cols(th, doms)
        thq = th.expand(q, bb, mth) if shared else th
        out.append((name, "fused", (x, w, thq, 0.0, float(denom), bb),
                    lambda x=x, w=w, thq=thq, d=denom, s=bb:
                    ref.vfl_fused_ref(x, w, thq, 0.0, d, s), None,
                    cs._nbytes(x, w, thq) + 4 * q * (bb * mw + dp * mth),
                    2.0 * q * dp * bb * (mw + mth), False))
    # the full-dataset passes over one X: forward (beside cuBLAS), backward
    # and the reduce over its workspace
    x = randn(q, n, dp)
    w = randn(q, dp, 1)
    out.append(("full_dataset_forward", "forward", (x, w),
                lambda: ref.vfl_forward_ref(x, w), lambda: torch.matmul(x, w),
                cs._nbytes(x, w) + q * n * 4, 2.0 * x.numel(), True))
    thq = randn(n, 1).expand(q, n, 1)
    zeros = torch.zeros((q, dp, 1), device=dev)
    out.append(("full_dataset", "backward", (x, thq, None, 0.0, float(n)),
                lambda: ref.vfl_backward_ref(x, thq, None, 0.0, n),
                lambda: torch.baddbmm(zeros, x.transpose(1, 2), thq,
                                      beta=0.0, alpha=1.0 / n),
                cs._nbytes(x, thq) + zeros.numel() * 4, 2.0 * x.numel(),
                True))
    # deep SVRG's μ over one X: layer 1's wide forward and its backward at
    # Mθ = 32 (rows and reduce), layer 2's forward and backward over n
    forward("deep_full_layer1", q, n, 32, big=True)
    forward("deep_full_layer2", q, n, 16, d=32, big=True)
    # (∂u and ϑ_z carry the path's 1/n, so the sums stay at its scale)
    for name, xx, m, shared in (("deep_full_w1", x, 32, False),
                                ("deep_full_w2", torch.tanh(randn(q, n, 32)),
                                 16, True)):
        cot = (randn(n, m) / n).expand(q, n, m) if shared \
            else randn(q, n, m) / n
        zz = torch.zeros((q, xx.shape[2], m), device=dev)
        out.append((name, "backward", (xx, cot, None, 0.0, 1.0),
                    lambda xx=xx, cot=cot: ref.vfl_backward_ref(
                        xx, cot, None, 0.0, 1),
                    lambda xx=xx, cot=cot, zz=zz: torch.baddbmm(
                        zz, xx.transpose(1, 2), cot, beta=0.0),
                    cs._nbytes(xx, cot) + zz.numel() * 4,
                    2.0 * xx.numel() * m, True))
    ws = randn(math.ceil(n / 1024), q, dp, 1)
    g = torch.empty((q, dp, 1), device=dev)
    out.append(("full_dataset_reduce", "reduce", (ws, None, g, float(n), 0.0),
                lambda: ws.sum(0) / n, lambda: torch.sum(ws, 0).div_(n),
                cs._nbytes(ws) + q * dp * 4, float(ws.numel()), False))
    return out


def epoch_steps(torch, dev, builds, order):
    """Host microseconds per step of an SGD and a pipelined SGD epoch at
    phase 7's universe, and the full-gradient pass's device milliseconds,
    each build in the given turns."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core.engine import EngineConfig, FusedEngine
    from repro_torch.core.losses import logistic_l2
    from repro_torch.kernels import vfl_grad as vg
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    x = torch.randn((cs.N, cs.D), generator=gen, device=dev)
    y = cs.d4_labels(torch, dev, x)
    layout = alg.PartyLayout.even(cs.D, cs.Q, cs.M_ACT)
    steps = cs.N // cs.TRAIN_BATCH
    idx = alg.epoch_indices(cs.SEED, 99, cs.N, cs.TRAIN_BATCH, steps, dev)
    kept, out = vg.KERNEL, {}
    prof = {name: {tag: [] for tag in builds}
            for name in ("sgd", "pipelined_sgd")}
    try:
        for name in ("sgd", "pipelined_sgd"):
            out[name] = {tag: [] for tag in builds}
            for tag in order:
                vg.KERNEL = builds[tag]
                eng = FusedEngine(logistic_l2(1e-4), x, y, layout,
                                  EngineConfig(secure="two_tree"),
                                  device=dev)
                wq = eng.pack_w(torch.full((cs.D,), 1e-3, device=dev))
                epoch = getattr(eng, f"{name}_epoch")
                epoch(wq, cs.TRAIN_LR, idx)          # captures the step
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                epoch(wq, cs.TRAIN_LR, idx)
                torch.cuda.synchronize()
                out[name][tag].append((time.perf_counter() - t0) * 1e6
                                      / steps)
                prof[name][tag].append(program_us(torch, epoch, wq, idx,
                                                  steps))
                del eng, epoch
            cs.log(f"{name} epoch, host us per step: " + "  ".join(
                f"{tag} {[round(t, 2) for t in ts]}"
                for tag, ts in out[name].items()))
            cs.log(f"{name} epoch, device us per step by program: "
                   + "  ".join(f"{tag} {ts}"
                               for tag, ts in prof[name].items()))
        out["profile_us_per_step"] = prof
        out["full_gradient_ms"] = {tag: [] for tag in builds}
        for tag in order:
            vg.KERNEL = builds[tag]
            eng = FusedEngine(logistic_l2(1e-4), x, y, layout,
                              EngineConfig(secure="two_tree"), device=dev)
            wq = eng.pack_w(torch.full((cs.D,), 1e-3, device=dev))
            eng.full_gradient(wq)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                eng.full_gradient(wq)
            end.record()
            end.synchronize()
            out["full_gradient_ms"][tag].append(start.elapsed_time(end) / 20)
            del eng
        cs.log("full-gradient pass, ms: " + "  ".join(
            f"{tag} {[round(t, 4) for t in ts]}"
            for tag, ts in out["full_gradient_ms"].items()))
    finally:
        vg.KERNEL = kept
    return out


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


def build_all(builds, prefixes):
    """Build every library of ``builds`` (tag -> ``CudaLibrary``), the
    ``nvcc`` runs started together; log each build's ``-Xptxas -v``
    summary and the registers and spills of its instances whose names
    start with one of ``prefixes``.  Returns {tag: summary}."""
    failed = []

    def build(lib):
        try:
            lib.library()
        except Exception as e:                  # relayed to the main thread
            failed.append(e)

    threads = [threading.Thread(target=build, args=(k,))
               for k in builds.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failed:
        raise failed[0]
    out = {}
    for tag, lib in builds.items():
        if lib.build_seconds is None:       # an earlier run's library
            cs.log(f"{tag}: reused, no build report")
            continue
        out[tag] = cs._ptxas_summary(lib.build_log)
        cs.log(f"{tag}: built in {lib.build_seconds:.1f} s; {out[tag]}")
        for line in cs._instances(lib.build_log, prefixes):
            cs.log(f"    {line}")
    return out


def write_sass(builds, out_dir, name):
    """Each library's ``cuobjdump -sass`` of the kernels whose demangled
    name holds ``name``, one file a build under ``out_dir``."""
    from repro_torch.kernels import build as vb
    out_dir.mkdir(parents=True, exist_ok=True)
    for tag, lib in builds.items():
        sass = subprocess.run(
            [str(Path(vb._nvcc()).with_name("cuobjdump")), "-sass",
             lib.library()._name], capture_output=True, text=True,
            timeout=300, check=True).stdout
        (out_dir / f"{tag}.sass").write_text("".join(
            "\tFunction : " + f for f in sass.split("\tFunction : ")
            if name in f.split("\n", 1)[0]))


def in_turns(torch, fns, order, **reps):
    """Device ms of one call of each ``fns[tag]``, timed by
    ``chip_smoke._graph_ms`` in the given order of tags (each tag in it
    twice: forward, then reversed)."""
    times = {tag: [] for tag in fns}
    for tag in order:
        times[tag].append(cs._graph_ms(torch, fns[tag], **reps))
    return times


def program_us(torch, epoch, wq, idx, steps):
    """Device microseconds per step of each ``vfl_grad`` program over one
    more run of a captured epoch, from a ``torch.profiler`` window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as pr:
        epoch(wq, cs.TRAIN_LR, idx)
        torch.cuda.synchronize()
    out = {}
    for ev in pr.key_averages():
        m = re.search(r"(vfl_\w+)<", ev.key)
        if ev.device_type == DeviceType.CUDA and m:
            out[m.group(1)] = round(out.get(m.group(1), 0.0)
                                    + ev.self_device_time_total / steps, 3)
    return out


def call(kern, kind, ops):
    """One call of ``kern``'s method for ``kind``; the outputs as a tuple."""
    if kind == "forward":
        return (kern.forward(*ops),)
    if kind == "backward":
        return (kern.backward(*ops),)
    if kind == "reduce":
        return (kern.reduce(*ops),)
    return kern.fused(*ops)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="the other vfl_grad.cu to build and time")
    ap.add_argument("--also", type=Path, nargs="*", default=[],
                    help="further variants of vfl_grad.cu to build and time")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "results" / "vfl_grad_ab.json")
    ap.add_argument("--sass", type=Path,
                    help="write the SASS of each build's vfl_forward "
                         "instances here (cuobjdump -sass)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("vfl_grad_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import vfl_grad as vg
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = card_line()
    cs.log(f"card: {smi}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    builds = {"base": vg.CudaKernel(), "new": vg.CudaKernel()}
    builds["base"].source = args.baseline.resolve()
    for path in args.also:
        builds[path.stem] = vg.CudaKernel()
        builds[path.stem].source = path.resolve()
    record = {"card": smi, "torch": torch.__version__,
              "baseline": str(args.baseline),
              "ptxas": build_all(builds, ("vfl_forward", "vfl_fused_split")),
              "rows": []}
    for tag, kern in builds.items():
        record[f"{tag}_build_log"] = kern.build_log
    if args.sass is not None:
        write_sass(builds, args.sass, "vfl_forward")
    tiny = torch.zeros(1, device=dev)
    record["floor_ms"] = cs._graph_ms(torch, tiny.zero_)
    cs.log(f"launch floor (a one-element fill): "
           f"{record['floor_ms'] * 1e3:.2f} us")
    ok = True
    order = list(builds) + list(builds)[::-1]
    for name, kind, ops, plain, library, nbytes, flops, big in cases(
            torch, dev):
        want = plain()
        want = want if isinstance(want, tuple) else (want,)
        row = {"name": name, "kind": kind}
        reps = dict(reps=10, replays=5) if big else {}
        fns, gs = {}, []
        for tag, kern in builds.items():
            # copies: the reduce writes the same g on every call
            got = tuple(t.clone() for t in call(kern, kind, ops))
            gs.append(got[-1])
            again = call(kern, kind, ops)
            torch.cuda.synchronize()
            err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
            close = all(torch.allclose(g, w_, **TOL)
                        for g, w_ in zip(got, want))
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            row[f"{tag}_err"], row[f"{tag}_repeat_equal"] = err, same
            ok &= close and same
            fns[tag] = (lambda k=kern: call(k, kind, ops))
        same = all(torch.equal(gs[0], g) for g in gs[1:])
        if kind == "forward":   # recorded: a redesign may change the order
            row["z_equal_across_builds"] = same
        else:                   # g: the backward sides are unchanged
            row["g_equal_across_builds"] = same
            ok &= same
        times = in_turns(torch, fns, order, **reps)
        row.update({f"{tag}_ms": ts for tag, ts in times.items()})
        row["library_ms"] = None if library is None \
            else cs._graph_ms(torch, library, **reps)
        row["bound_ms"], row["bound_by"] = cs._bound(nbytes, flops)
        record["rows"].append(row)
        lib = "-" if row["library_ms"] is None \
            else f"{row['library_ms'] * 1e3:.2f}"
        what = "z" if kind == "forward" else "g"
        cs.log(f"{name}: library {lib} us, bound "
               f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}), "
               f"{what} equal across builds {same}")
        for tag, ts in times.items():
            cs.log(f"    {tag:14s} {sum(ts) / len(ts) * 1e3:9.2f} us "
                   f"{[round(t * 1e3, 2) for t in ts]}  err "
                   f"{row[f'{tag}_err']:.2e}  repeat-equal "
                   f"{row[f'{tag}_repeat_equal']}")
    record["epoch_step_us"] = epoch_steps(torch, dev, builds, order)
    record["ok"] = ok
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(record, indent=1))
    print(smi)
    print(json.dumps({"ok": ok, "floor_ms": record["floor_ms"], "rows": [
        {k: v for k, v in r.items() if k.endswith("ms") or k == "name"}
        for r in record["rows"]], "epoch_step_us": record["epoch_step_us"]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
