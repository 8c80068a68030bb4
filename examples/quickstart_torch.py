"""Quickstart on the PyTorch port: VFB² on vertically partitioned data.

The counterpart of ``examples/quickstart.py``.  Eight parties hold
disjoint feature blocks of a credit-scoring-shaped dataset; three of them
have labels.  It trains ℓ2-regularized logistic regression with
VFB²-SVRG (backward updating) and checks the three headline claims:
  1. losslessness: the same iterate as non-federated training;
  2. the AFSVRG-VP baseline (no BUM, so the passive blocks stay frozen)
     is lossy;
  3. secure aggregation (Algorithm 1) is exact: the masks cancel.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import algorithms, losses, trees
from repro_torch.core.secure_agg import secure_aggregate_host
from repro_torch.data.synthetic import classification_dataset
from repro_torch.data.vertical import vertical_split


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device
    ds = classification_dataset("credit", n=6000, d=90, seed=0,
                                onehot_frac=0.4, noise=0.4)
    q, m = 8, 3
    blocks, layout = vertical_split(ds.x_train, q=q, m=m)
    print(f"{q} parties ({m} active), feature blocks:",
          [b.shape[1] for b in blocks])

    # --- secure aggregation (Algorithm 1, on the host) --------------------
    t1, t2 = trees.default_tree_pair(q)
    assert trees.significantly_different(t1, t2)
    rng = np.random.default_rng(0)
    w_demo = rng.standard_normal(ds.x_train.shape[1])
    partials = [blocks[p][0] @ w_demo[lo:hi]
                for p, (lo, hi) in enumerate(layout.bounds)]
    agg, _ = secure_aggregate_host([np.atleast_1d(p) for p in partials], rng)
    got, true = float(np.ravel(agg)[0]), float(ds.x_train[0] @ w_demo)
    print(f"secure wᵀx = {got:.6f}  (true {true:.6f})")
    assert abs(got - true) <= 1e-5 * max(1.0, abs(true)), (got, true)

    # --- train --------------------------------------------------------------
    prob = losses.logistic_l2()
    kw = dict(algo="svrg", epochs=12, lr=0.5, batch=32, seed=0, device=dev)
    vfb2 = algorithms.train(prob, ds.x_train, ds.y_train, layout, **kw)
    nonf = algorithms.train(prob, ds.x_train, ds.y_train,
                            algorithms.PartyLayout.even(90, 1, 1), **kw)
    vp = algorithms.train(prob, ds.x_train, ds.y_train, layout,
                          active_only=True, **kw)

    def acc(r):
        return algorithms.accuracy(r.w, ds.x_test, ds.y_test)

    lossless = np.allclose(vfb2.w, nonf.w, atol=1e-6)
    gap = acc(nonf) - acc(vp)
    print(f"\naccuracy: VFB²-SVRG {acc(vfb2):.4f} | NonF {acc(nonf):.4f} "
          f"| AFSVRG-VP {acc(vp):.4f}")
    print("lossless (VFB² == NonF):", lossless)
    print(f"VP accuracy gap: {gap:.4f}")
    assert lossless, "VFB² left the non-federated iterate"
    assert gap > 0, "freezing the passive blocks did not cost accuracy"


if __name__ == "__main__":
    main()
