"""The port's data generators are array-equal to the reference's.

``repro_torch.data`` is a numpy copy of ``repro.data``'s synthetic
generators and vertical split, so the same seed must give the same
arrays, bit for bit.
"""
import numpy as np
import pytest

from repro_torch import data as tdata


def _equal_datasets(a, b):
    assert (a.name, a.task) == (b.name, b.task)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        ga, gb = getattr(a, f), getattr(b, f)
        assert ga.dtype == gb.dtype
        np.testing.assert_array_equal(ga, gb)


@pytest.mark.parametrize("kw", [
    dict(name="eng", n=1000, d=50, seed=3, noise=0.4),
    dict(name="D1", n=600, d=90, seed=0, onehot_frac=0.4),
    dict(name="D4", n=300, d=4096, seed=3),
])
def test_classification_dataset_matches_reference(kw):
    from repro.data import synthetic
    _equal_datasets(tdata.classification_dataset(**kw),
                    synthetic.classification_dataset(**kw))


@pytest.mark.parametrize("seed", [0, 5])
def test_regression_dataset_matches_reference(seed):
    from repro.data import synthetic
    _equal_datasets(tdata.regression_dataset("D6", 900, 90, seed=seed),
                    synthetic.regression_dataset("D6", 900, 90, seed=seed))


def test_paper_datasets_match_reference():
    from repro.data import synthetic
    port = tdata.paper_datasets(scale=0.02, seed=1)
    ref = synthetic.paper_datasets(scale=0.02, seed=1)
    assert list(port) == list(ref)
    for k in ref:
        _equal_datasets(port[k], ref[k])


@pytest.mark.parametrize("seed", [None, 4])
def test_vertical_split_matches_reference(seed):
    from repro.data import vertical
    x = np.random.default_rng(2).standard_normal((20, 13)).astype(np.float32)
    blocks, layout = tdata.vertical_split(x, 4, 2, seed=seed)
    rblocks, rlayout = vertical.vertical_split(x, 4, 2, seed=seed)
    assert (layout.q, layout.m, layout.bounds) == \
        (rlayout.q, rlayout.m, rlayout.bounds)
    for a, b in zip(blocks, rblocks, strict=True):
        np.testing.assert_array_equal(a, b)
