"""Cross-epoch reuse on the PyTorch port's fused engine.

The counterpart of ``examples/compile_reuse.py``.  On the card each epoch
kind's step is captured once as a CUDA graph per (kind, schedule shape)
and every later epoch of that kind replays it: a chain of epochs

    w = epoch(w, ...); w = epoch(w, ...); ...

captures once and then only replays.  This demo chains three schedules
back to back on ONE engine: linear multi-dominator epochs, deep
multi-dominator epochs and pipelined deep epochs.  On the card it checks
one captured graph per kind, the same graph object after every epoch
and the same ``vfl_grad`` launches in every epoch of a kind; on any
device it checks that the chained epochs give the bits of the same
epochs run kind by kind on engines of their own.

    PYTHONPATH=src python examples/compile_reuse_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import algorithms, deep_vfl, losses
from repro_torch.core.engine import EngineConfig, FusedEngine
from repro_torch.data.synthetic import classification_dataset
from repro_torch.kernels import vfl_grad as vg

EPOCHS = 6
BATCH = 32
D = 64
# (label, epoch method, deep, rows a step: m·B for the multi-dominator
# kinds, B for the pipelined one, its learning rate)
KINDS = (("linear multi-dominator SGD", "multi_sgd", False, 2, 0.2),
         ("deep multi-dominator SGD", "deep_multi_sgd", True, 2, 0.05),
         ("deep pipelined SGD (one split launch an interior step)",
          "deep_pipelined_sgd", True, 1, 0.05))


def _engine(ds, layout, prob, dev):
    return FusedEngine(prob, ds.x_train, ds.y_train, layout,
                       EngineConfig(secure="off"), device=dev)


def _start(eng, deep, params):
    return eng.pack_deep(params) if deep \
        else eng.pack_w(np.zeros(D, np.float32))


def _schedules(n, rows):
    steps = n // rows
    return [algorithms.epoch_indices(0, ep, n, rows, steps)
            for ep in range(EPOCHS)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        vg.KERNEL.library()     # build the kernel before the clocks start
    ds = classification_dataset("reuse", 1200, D, seed=0, noise=0.4)
    layout = algorithms.PartyLayout.even(D, 4, 2)
    prob = losses.logistic_l2()
    n = ds.x_train.shape[0]
    params = deep_vfl.init_deep_vfl(torch.Generator().manual_seed(0),
                                    layout, D, 32, 16)

    print("chaining fused epochs on one engine:")
    eng = _engine(ds, layout, prob, dev)
    chained = {}
    for label, kind, deep, m, lr in KINDS:
        epoch = getattr(eng, kind + "_epoch")
        carry = _start(eng, deep, params)
        graphs, launches, times = [], [], []
        for ep, idx in enumerate(_schedules(n, m * BATCH)):
            before = dict(vg.KERNEL.launches)
            t0 = time.perf_counter()
            carry = epoch(carry, lr, idx, (0, ep))
            if on_card:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append({k: v - before[k]
                             for k, v in vg.KERNEL.launches.items()
                             if v != before[k]})
            # a deep loop's name carries the deep widths
            graphs.append([loop.graph for key, loop in eng._loops.items()
                           if key[0] == kind or key[0].startswith(kind + "_")])
        chained[kind] = carry
        objective = eng.deep_objective(carry) if deep \
            else eng.objective(carry)
        print(f"  {label}: first epoch {times[0] * 1e3:.1f}ms (the "
              f"graph's capture on the card), "
              f"then {np.mean(times[1:]) * 1e3:.2f}ms/epoch; objective "
              f"{objective:.4f}")
        assert all(len(g) == 1 for g in graphs), (
            f"{kind}: one step loop per kind and shape: {graphs}")
        if on_card:
            graph = graphs[0][0]
            assert graph is not None and all(g[0] is graph for g in graphs), (
                f"{kind}: the epochs did not replay one captured graph")
            assert launches[0] and all(x == launches[0] for x in launches), (
                f"{kind}: epochs launched {launches}, not the same each")
            print(f"    one CUDA graph captured, replayed by all {EPOCHS} "
                  f"epochs ({launches[0]} launches an epoch)")
    print(f"step loops on the engine: {sorted(k[0] for k in eng._loops)}")

    print("the same epochs kind by kind, each on an engine of its own:")
    for label, kind, deep, m, lr in KINDS:
        own = _engine(ds, layout, prob, dev)
        carry = _start(own, deep, params)
        for ep, idx in enumerate(_schedules(n, m * BATCH)):
            carry = getattr(own, kind + "_epoch")(carry, lr, idx, (0, ep))
        got = chained[kind] if deep else (chained[kind],)
        want = carry if deep else (carry,)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"  {label}: chained == unchained: {same}")
        assert same, f"{kind}: chaining on one engine changed the epochs"


if __name__ == "__main__":
    main()
