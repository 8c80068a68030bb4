"""End-to-end example on the PyTorch port: train a language model under the
VFB² framework (the counterpart of ``examples/train_lm.py``).

Synthetic token stream → secure vocab-parallel VFL embedding (masked
two-tree aggregation + BUM backward) → decoder stack → vocab-parallel
loss → AdamW or the bounded-staleness VFB²-SGD optimiser → checkpoint.
Defaults to a CPU-sized reduced config; on the card (the default device)
or, with ``--device cpu``, on the CPU::

    PYTHONPATH=src python examples/train_lm_torch.py --steps 60 --device cpu

    PYTHONPATH=src python examples/train_lm_torch.py --arch falcon_mamba_7b \\
        --optimizer vfb2_sgd --lr 0.3 --tau 4
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import OPTIMIZERS, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_1_6b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw", choices=OPTIMIZERS)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    losses = train(a.arch, a.steps, a.batch, a.seq, a.lr, a.optimizer,
                   a.tau, reduced=True, ckpt_dir=a.ckpt, device=a.device)
    drop = losses[0] - losses[-1]
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}  (drop {drop:.3f}; "
          f"unigram-entropy baseline would plateau near the start value)")
    assert drop > 0.05, "training did not reduce the loss"


if __name__ == "__main__":
    main()
