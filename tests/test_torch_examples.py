"""The port's training examples, run on the CPU as a user would run them
(``--device cpu``): each ends in its own assertions, which must hold.

* ``examples/quickstart_torch.py``: losslessness, the lossy AFSVRG-VP
  baseline and exact secure aggregation;
* ``examples/deep_vfl_torch.py``: deep VFB² against the centralized
  oracle, the frozen-passive baseline and the fused engine under secure
  two-tree aggregation;
* ``examples/compile_reuse_torch.py``: linear multi-dominator, deep
  multi-dominator and pipelined deep epochs chained on one engine, equal
  to the same epochs on engines of their own (the one-graph-per-kind
  check runs only on the card).
"""
import pathlib
import runpy
import sys

import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
# example: lines its output must hold
EXPECT = {"quickstart_torch": ["lossless (VFB² == NonF): True"],
          "deep_vfl_torch": ["lossless: True",
                             "fused engine tracks the oracle: True"],
          "compile_reuse_torch": ["chained == unchained: True"]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its ops are small, and
    the suite runs several test processes on one machine's cores, where
    more threads a process only contend.  The count is put back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(EXPECT))
def test_example_runs_on_the_cpu(name, monkeypatch, capsys):
    path = EXAMPLES / f"{name}.py"
    monkeypatch.setattr(sys, "argv", [str(path), "--device", "cpu"])
    runpy.run_path(str(path), run_name="__main__")
    out = capsys.readouterr().out
    for line in EXPECT[name]:
        assert line in out, out
