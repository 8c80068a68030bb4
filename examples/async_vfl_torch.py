"""BAPA in action on the PyTorch port: bilevel asynchronous VFL against its
synchronous counterpart, then the fused multi-dominator engine serving the
same m-active-party regime, then pipelined epochs.

The counterpart of ``examples/async_vfl.py``.  It runs the thread
simulation (the paper's own experimental setup) with a 45% straggler party
and prints loss-against-wall-time traces for both systems, the parties'
arithmetic on the card through the ``vfl_grad`` kernel; then the
deterministic counterpart of the 3-dominator regime on the fused engine
(``train(..., multi_dominator=True, engine="fused")``: all three
dominators' minibatches ride one launch a step); then five pipelined τ = 1
epochs (backward(t) ∥ forward(t+1) in one split-batch launch a step).  An
epoch's step is captured once as a CUDA graph and replayed: the script
checks that all five epochs replayed the one graph of their kind, the
counterpart of the reference's jit-cache assertion.

    PYTHONPATH=src python examples/async_vfl_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import algorithms, async_engine, losses
from repro_torch.core.engine import EngineConfig, FusedEngine
from repro_torch.data.synthetic import classification_dataset
from repro_torch.kernels import vfl_grad as vg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device
    if torch.device(dev).type == "cuda":
        vg.KERNEL.library()     # build the kernel before the clocks start
    ds = classification_dataset("async-demo", 1200, 64, seed=0, noise=0.4)
    layout = algorithms.PartyLayout.even(64, 8, 3)
    prob = losses.logistic_l2()
    speeds = [1.0] * 8
    speeds[-1] = 1.45  # straggler
    kw = dict(lr=0.2, batch=16, total_epochs=5.0, base_delay=2e-3,
              speed_factors=speeds, device=dev)

    print("async (VFB², bilevel: 3 dominators × 3 threads/party)...")
    a = async_engine.run_async(prob, ds.x_train, ds.y_train, layout,
                               threads_per_party=3, **kw)
    print("sync (VFB, barrier per iteration)...")
    s = async_engine.run_sync(prob, ds.x_train, ds.y_train, layout, **kw)

    print(f"\nwall time: async {a.wall_time:.2f}s vs sync {s.wall_time:.2f}s"
          f"  (speedup {s.wall_time / a.wall_time:.2f}x)")
    print("\nloss traces (t, epochs, objective):")
    for name, res in [("async", a), ("sync", s)]:
        pts = res.loss_trace[:: max(1, len(res.loss_trace) // 6)]
        print(f"  {name}: " + "  ".join(f"({t:.2f}s,{e:.1f}ep,{o:.4f})"
                                        for t, e, o in pts))

    print("\nfused multi-dominator engine (same 3-active-party regime, "
          "one launch a step)...")
    t0 = time.perf_counter()
    res = algorithms.train(prob, ds.x_train, ds.y_train, layout,
                           algo="sgd", epochs=5, lr=0.2, batch=16,
                           engine="fused", multi_dominator=True, device=dev)
    dt = time.perf_counter() - t0
    print(f"  5 epochs in {dt:.2f}s (graph capture included) -> objective "
          f"{res.history[-1]['objective']:.4f} vs async thread sim "
          f"{a.loss_trace[-1][2]:.4f}")

    print("\npipelined τ=1 epochs (backward(t) ∥ forward(t+1), one split "
          "launch a step, the step a CUDA graph replay)...")
    eng = FusedEngine(prob, ds.x_train, ds.y_train, layout,
                      EngineConfig(secure="off"), device=dev)
    n = ds.x_train.shape[0]
    steps = n // 16
    wq = eng.pack_w(np.zeros(64, np.float32))
    before = vg.KERNEL.launches["vfl_fused_split"]
    t0 = time.perf_counter()
    for ep in range(5):
        idx = algorithms.epoch_indices(0, ep, n, 16, steps, eng.device)
        wq = eng.pipelined_sgd_epoch(wq, 0.2, idx, (0, ep))
    dt = time.perf_counter() - t0
    loops = [k for k in eng._loops if k[0] == "pipelined_sgd"]
    assert len(loops) == 1, f"one step loop per kind and shape: {loops}"
    split = vg.KERNEL.launches["vfl_fused_split"] - before
    if eng.device.type == "cuda":
        graph = eng._loops[loops[0]].graph
        assert graph is not None and split == 5 * (steps - 1), (
            f"pipelined epochs launched {split} split steps, not "
            f"{5 * (steps - 1)} from one captured graph")
        note = (f"one CUDA graph captured, replayed by all 5 epochs "
                f"({split} split launches)")
    else:
        note = "eager steps on the CPU (no graph)"
    print(f"  5 epochs in {dt:.2f}s -> objective "
          f"{eng.objective(wq):.4f}; {note}")


if __name__ == "__main__":
    main()
