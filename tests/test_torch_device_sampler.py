"""PyTorch port, the device pair samplers (``train/device_sampler.py``)
against the JAX package's (``bridged_gnn_tpu/train/device_sampler.py``)
and the host enumerators, on the CPU: shapes equal to JAX's
``num_pairs`` and the host sampler's; valid train rows, class-balanced
cartesian order, cross sides, a rotating class subset over the cap;
targets from the labels; ``DeviceBalancedSampler``'s slot pattern equal
to JAX's ``_slots1``/``_slots2`` and its same/different composition
equal to the host sampler's; per-id draw frequencies uniform within each
class by a chi-square test at a fixed seed.

The streams are torch's, so a draw is compared with JAX's by what it is
(rows, classes, order, counts), never element for element.
"""

import numpy as np
import pytest
import torch
from scipy.stats import chi2

from bridged_gnn_tpu.train import device_sampler as jds

from bridged_gnn_tpu_torch.data.datasets import dataset_conversion
from bridged_gnn_tpu_torch.data.synthetic import make_sync_dataset
from bridged_gnn_tpu_torch.train import device_sampler as tds
from bridged_gnn_tpu_torch.train.samplers import (
    PairEnumerator,
    PairEnumeratorCross,
)

MAX_CLS, SIZE = 4, 1600
# a chi-square statistic whose upper tail is below this fails the test:
# at a fixed seed the draw is fixed, so this is a check of the formula,
# not a flaky bound
CHI2_P = 1e-3


@pytest.fixture(scope="module")
def domains():
    data = make_sync_dataset("relational-intra", n_src=300, n_tar=200,
                             dim=16, num_classes=4, avg_degree=4, seed=0)
    src, tar, _, _ = dataset_conversion(data, seed=0)
    return src, tar


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("max_cls", [MAX_CLS, 2])
def test_shapes_equal_jax_and_host(domains, cross, max_cls):
    src, tar = domains
    rng = np.random.default_rng(0)
    if cross:
        t = tds.DevicePairSamplerCross(src, tar, max_cls, SIZE)
        j = jds.DevicePairSamplerCross(src, tar, max_cls, SIZE)
        h1, h2 = PairEnumeratorCross(src, tar, "train", rng).sampling(
            max_cls, SIZE)
    else:
        t = tds.DevicePairSampler(src, max_cls, SIZE)
        j = jds.DevicePairSampler(src, max_cls, SIZE)
        h1, h2 = PairEnumerator(src, "train", rng).sampling(max_cls, SIZE)
    d1, d2 = t.sample(_gen(0))
    assert t.num_pairs == j.num_pairs == len(h1) == len(d1) == len(d2)
    assert (t.m, t.per_class, t.num_nonempty) == (j.m, j.per_class,
                                                  j.num_nonempty)
    assert d1.dtype == d2.dtype == torch.int64


def test_within_pairs_are_train_rows_balanced_cartesian(domains):
    """Side 1 tiles, side 2 repeats (pair_enumeration order), every id a
    train row, per_class ids of each selected class on each side."""
    src, _ = domains
    y = np.asarray(src["y"])
    train = np.asarray(src["train_mask"])
    dev = tds.DevicePairSampler(src, MAX_CLS, SIZE)
    d1, d2 = (a.numpy() for a in dev.sample(_gen(2)))
    assert train[d1].all() and train[d2].all()
    n = int(np.sqrt(len(d1)))
    assert (d1.reshape(n, n) == d1[:n]).all()
    assert (d2.reshape(n, n) == d2.reshape(n, n)[:, :1]).all()
    for side in (d1[:n], d2.reshape(n, n)[:, 0]):
        counts = np.bincount(y[side], minlength=y.max() + 1)
        assert sorted(counts[counts > 0].tolist()) == [dev.per_class] * dev.m
        # class-major blocks of per_class ids
        blocks = y[side].reshape(dev.m, dev.per_class)
        assert (blocks == blocks[:, :1]).all()
    # both sides draw the same classes in the same block order
    b1 = y[d1[:n]].reshape(dev.m, -1)[:, 0]
    b2 = y[d2.reshape(n, n)[:, 0]].reshape(dev.m, -1)[:, 0]
    np.testing.assert_array_equal(b1, b2)


def test_cross_sides_come_from_their_domains(domains):
    src, tar = domains
    dev = tds.DevicePairSamplerCross(src, tar, MAX_CLS, SIZE)
    c1, c2 = (a.numpy() for a in dev.sample(_gen(3)))
    assert (c1 < src["x"].shape[0]).all() and (c2 < tar["x"].shape[0]).all()
    assert np.asarray(src["train_mask"])[c1].all()
    assert np.asarray(tar["train_mask"])[c2].all()


def test_class_subset_rotates_over_the_cap_and_is_uniform(domains):
    """Over the cap (2 of 4 classes) the selected subsets change from draw
    to draw, and over 600 draws every class is picked at the rate m /
    nonempty (chi-square, p > CHI2_P)."""
    src, _ = domains
    y = np.asarray(src["y"])
    dev = tds.DevicePairSampler(src, 2, SIZE)
    assert dev.m == 2 < dev.num_nonempty == 4
    gen = _gen(4)
    n = dev.per_class * dev.m
    subsets, picks = set(), np.zeros(4)
    for _ in range(600):
        d1, _ = dev.sample(gen)
        classes = sorted(set(y[d1.numpy()[:n]].tolist()))
        assert len(classes) == 2
        subsets.add(tuple(classes))
        picks[classes] += 1
    assert len(subsets) == 6     # every 2-subset of 4 classes
    expect = np.full(4, 600 * 2 / 4)
    assert chi2.sf(((picks - expect) ** 2 / expect).sum(), 3) > CHI2_P


def test_draw_frequencies_are_uniform_within_each_class(domains):
    """Side-1 ids over 300 draws: within each class every train row is
    drawn at the same rate (chi-square per class, p > CHI2_P), and no
    other row is drawn."""
    src, _ = domains
    y = np.asarray(src["y"])
    train = np.asarray(src["train_mask"])
    dev = tds.DevicePairSampler(src, MAX_CLS, SIZE)
    n = dev.per_class * dev.m
    counts = np.zeros(len(y))
    gen = _gen(5)
    for _ in range(300):
        d1, _ = dev.sample(gen)
        np.add.at(counts, d1.numpy()[:n], 1)
    assert counts[~train].sum() == 0
    for c in range(MAX_CLS):
        rows = np.flatnonzero(train & (y == c))
        got = counts[rows]
        expect = got.sum() / len(rows)
        stat = ((got - expect) ** 2 / expect).sum()
        assert chi2.sf(stat, len(rows) - 1) > CHI2_P, (c, stat)


def test_epoch_targets_match_labels(domains):
    src, tar = domains
    samplers, labels = tds.build_device_samplers(src, tar, MAX_CLS, SIZE)
    idxs, y_pairs = tds.sample_epoch_on_device(samplers, labels, _gen(0))
    ys, yt = np.asarray(src["y"]), np.asarray(tar["y"])
    for rel, y1, y2 in (("src", ys, ys), ("tar", yt, yt),
                        ("cross", ys, yt)):
        assert y_pairs[rel].dtype == torch.float32
        np.testing.assert_array_equal(
            y_pairs[rel].numpy(),
            (y1[idxs[f"{rel}1"].numpy()]
             == y2[idxs[f"{rel}2"].numpy()]).astype(np.float32))


def test_sampling_follows_the_generator(domains):
    src, _ = domains
    dev = tds.DevicePairSampler(src, 2, SIZE)
    a, b, c = (dev.sample(_gen(s)) for s in (7, 7, 8))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


@pytest.mark.parametrize("split,cross", [("val", False), ("test", True),
                                         ("train", False)])
def test_balanced_slot_pattern_equals_jax(domains, split, cross):
    """The static (c1, c2) slot pattern is JAX's, and a draw's same-class
    count and shape are the host ``balanced_sampling``'s."""
    src, tar = domains
    y_src = np.asarray(src["y"])
    nc = int(y_src.max()) + 1
    data2 = tar if cross else None
    t = tds.DeviceBalancedSampler(src, nc, 2000, split, data2=data2)
    j = jds.DeviceBalancedSampler(src, nc, 2000, split, data2=data2)
    np.testing.assert_array_equal(t.slots1.numpy(), np.asarray(j._slots1))
    np.testing.assert_array_equal(t.slots2.numpy(), np.asarray(j._slots2))
    assert t.num_pairs == j.num_pairs
    rng = np.random.default_rng(0)
    host = (PairEnumeratorCross(src, tar, split, rng) if cross
            else PairEnumerator(src, split, rng))
    h1, h2 = host.balanced_sampling(nc, 2000)
    d1, d2 = (a.numpy() for a in t.sample(_gen(1)))
    y2 = np.asarray(tar["y"]) if cross else y_src
    assert d1.shape == h1.shape and d2.shape == h2.shape
    assert (y_src[d1] == y2[d2]).sum() == (y_src[h1] == y2[h2]).sum()
    assert np.asarray(src[f"{split}_mask"])[d1].all()
    assert np.asarray((tar if cross else src)[f"{split}_mask"])[d2].all()


def test_too_small_samples_raise_as_jax(domains):
    src, _ = domains
    for cls in (tds.DevicePairSampler, tds.DeviceBalancedSampler):
        with pytest.raises(ValueError, match="too small"):
            cls(src, MAX_CLS, 3)
