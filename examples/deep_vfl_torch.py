"""Deep VFB² on the PyTorch port: the paper's protocol with nonlinear
party-local encoders.

The counterpart of ``examples/deep_vfl.py``.  Each party trains a private
one-hidden-layer encoder on its feature block; representations are
summed securely (Algorithm 1) and the BUM broadcasts ϑ backward, so only
ϑ crosses a party boundary.  The trajectory matches one centralized
autograd graph (losslessness at deep-model scale, λ∇g included),
freezing the passive encoders (no BUM) costs loss, and the fused engine
(``core.engine``: the ``vfl_grad`` kernel on the card, each epoch's step
a CUDA graph replay) tracks the sequential oracle under secure two-tree
aggregation.

    PYTHONPATH=src python examples/deep_vfl_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import algorithms, deep_vfl, losses
from repro_torch.core.algorithms import PartyLayout
from repro_torch.core.engine import EngineConfig
from repro_torch.data.synthetic import classification_dataset
from repro_torch.kernels import vfl_grad as vg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device
    if torch.device(dev).type == "cuda":
        vg.KERNEL.library()     # build the kernel before the clocks start
    ds = classification_dataset("deep", 2000, 32, seed=5, noise=0.4)
    layout = PartyLayout.even(32, 4, 2)
    prob = losses.logistic_l2()
    kw = dict(epochs=10, lr=0.05, batch=32, seed=0, device=dev)

    print("training deep VFL (BUM gradients, protocol message boundary)...")
    t0 = time.perf_counter()
    _, hist_vfl = deep_vfl.train_deep_vfl(prob, ds.x_train, ds.y_train,
                                          layout, **kw)
    dt_oracle = time.perf_counter() - t0
    print("training the centralized oracle (one autograd graph)...")
    _, hist_c = deep_vfl.train_centralized(prob, ds.x_train, ds.y_train,
                                           layout, **kw)
    print("training with frozen passive encoders (no BUM)...")
    _, hist_f = deep_vfl.train_deep_vfl(prob, ds.x_train, ds.y_train,
                                        layout, freeze_passive=True, **kw)
    print("training on the fused engine (secure two-tree aggregation)...")
    t0 = time.perf_counter()
    res = algorithms.train(prob, ds.x_train, ds.y_train, layout,
                           algo="sgd", deep=True, engine="fused",
                           engine_config=EngineConfig(secure="two_tree"),
                           **kw)
    dt_fused = time.perf_counter() - t0
    hist_eng = [h["objective"] for h in res.history]

    lossless = np.allclose(hist_vfl, hist_c, atol=1e-4)
    tracks = np.allclose(hist_vfl, hist_eng, atol=1e-4)
    bum = hist_f[-1] - hist_vfl[-1]
    print(f"\nfinal loss: VFB²-deep {hist_vfl[-1]:.4f} | centralized "
          f"{hist_c[-1]:.4f} | frozen-passive {hist_f[-1]:.4f} | "
          f"fused+secure {hist_eng[-1]:.4f}")
    print("lossless:", lossless)
    print("fused engine tracks the oracle:", tracks)
    print(f"BUM advantage over frozen passive: {bum:+.4f}")
    print(f"wall clock on {dev}: oracle {dt_oracle:.2f}s vs fused (graph "
          f"capture included) {dt_fused:.2f}s")
    assert lossless, "deep VFB² left the centralized trajectory"
    assert tracks, "the fused engine left the oracle's trajectory"
    assert bum > 0, "freezing the passive encoders did not cost loss"


if __name__ == "__main__":
    main()
