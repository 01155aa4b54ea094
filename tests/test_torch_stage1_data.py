"""PyTorch port, stage 1's data: the pair samplers, the stratified splits
and ``prepare_datasets`` against the JAX package. The samplers draw the
same pairs from the same ``np.random.Generator``; the splits draw from an
explicit ``torch.Generator`` where the JAX package seeds torch's global
one, and give the same masks. ``prepare_datasets`` gives the same dicts
and mappers for the synthetic datasets and for raw files built here: a
twitter ``.npy`` VS-graph, an office ``.dat`` pickle and two facebook100
``.mat`` universities (``tests/test_facebook100.py::make_fake_univ_mat``).
"""

import os

import numpy as np
import pytest
import torch

from bridged_gnn_tpu.data import datasets as jds
from bridged_gnn_tpu.data import facebook100 as jfb
from bridged_gnn_tpu.graph import domain_split_np as j_domain_split_np
from bridged_gnn_tpu.train import samplers as jsam

from bridged_gnn_tpu_torch.data import datasets as tds
from bridged_gnn_tpu_torch.data import facebook100 as tfb
from bridged_gnn_tpu_torch.data.synthetic import make_sync_dataset
from bridged_gnn_tpu_torch.graph import domain_split_np
from bridged_gnn_tpu_torch.train import samplers as tsam

from tests.test_facebook100 import make_fake_univ_mat
from tests.test_torch_zoo import write_dat


def assert_same_dict(got, want, what=""):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, f"{what}{k}: {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}{k}")


def assert_same_prepared(got, want):
    for i, name in enumerate(("src", "tar", "merged")):
        assert_same_dict(got[i], want[i], f"{name}.")
    assert got[3] == want[3] and got[4] == want[4]


def _split_data(seed=0):
    data = make_sync_dataset("relational-intra", n_src=70, n_tar=50, dim=6,
                             num_classes=3, seed=seed)
    data["y"] = data["y"].copy()
    data["y"][::13] = -1
    return data


# --------------------------------------------------------------- samplers


@pytest.mark.parametrize("shuffle", [False, True])
def test_samplers_draw_the_same_pairs(shuffle):
    data = _split_data()
    src, tar, _, _ = tds.dataset_conversion(data, seed=0)
    for mode in ("train", "val", "test", "all"):
        rj, rt = np.random.default_rng(7), np.random.default_rng(7)
        js = (jsam.PairEnumerator(src, mode, rj),
              jsam.PairEnumerator(tar, mode, rj),
              jsam.PairEnumeratorCross(src, tar, mode, rj))
        ts = (tsam.PairEnumerator(src, mode, rt),
              tsam.PairEnumerator(tar, mode, rt),
              tsam.PairEnumeratorCross(src, tar, mode, rt))
        for _ in range(2):
            for j, t in zip(js, ts):
                for fn, kw in (("sampling", dict(max_class_num=2,
                                                 sample_size=400)),
                               ("balanced_sampling", dict(
                                   max_class_num=3, sample_size=300))):
                    a = getattr(j, fn)(shuffle=shuffle, **kw)
                    b = getattr(t, fn)(shuffle=shuffle, **kw)
                    for x, y in zip(a, b):
                        np.testing.assert_array_equal(x, y)
    idx1, idx2 = np.arange(5), np.arange(3) + 10
    for x, y in zip(jsam.enumerate_all_pairs(idx1, idx2),
                    tsam.enumerate_all_pairs(idx1, idx2)):
        np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------- splits


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_splits_and_conversion_match_jax(seed):
    """``dataset_split`` (restricted and not) and ``dataset_conversion``
    (with and without a target split) give the JAX package's masks; the
    port leaves torch's global generator as it was."""
    data = _split_data(seed)
    n = data["x"].shape[0]
    for restrict in (None, ~data["central_mask"]):
        dj = {m: np.zeros(n, bool) for m in ("train_mask", "val_mask",
                                             "test_mask")}
        dt = {k: v.copy() for k, v in dj.items()}
        torch.manual_seed(seed)
        jds.dataset_split(dict(dj, y=data["y"]), 3, (0.6, 0.2, 0.2),
                          restrict_mask=restrict)
        before = torch.random.get_rng_state()
        tds.dataset_split(dict(dt, y=data["y"]), 3, (0.6, 0.2, 0.2),
                          restrict_mask=restrict,
                          generator=tds.split_generator(seed))
        assert torch.equal(torch.random.get_rng_state(), before)
        assert_same_dict(dt, dj)
    data.update({m: np.asarray(data["central_mask"]) & False
                 for m in ("train_mask", "val_mask", "test_mask")})
    data["train_mask"][::3] = True
    data["val_mask"][1::3] = True
    for split_data in (True, False):
        for name in (None, "twitter_x"):
            want = jds.dataset_conversion(dict(data), seed=seed,
                                          dataset_name=name,
                                          split_data=split_data)
            got = tds.dataset_conversion(dict(data), seed=seed,
                                         dataset_name=name,
                                         split_data=split_data)
            assert_same_dict(got[0], want[0], "src.")
            assert_same_dict(got[1], want[1], "tar.")
            assert got[2:] == want[2:]
    for a, b in zip(domain_split_np(data), j_domain_split_np(data)):
        if isinstance(a, dict) and "x" in a:
            assert_same_dict(a, b)
        else:
            assert a == b


def test_facebook100_graph_splits_match_jax(tmp_path):
    """Both of ``build_fb100_graph``'s splits (count-based, ratio) and the
    heterophily labels, against the JAX package's."""
    path = os.path.join(tmp_path, "U.mat")
    make_fake_univ_mat(path, n=160, num_classes=3, seed=3)
    for kw in (dict(train_val_test_ratio=None, num_val=30, num_test=40),
               dict(train_val_test_ratio=None, num_val=30),
               dict(train_val_test_ratio=(0.4, 0.3, 0.3), to_onehot=True),
               dict(heterophily=True, seed=4)):
        assert_same_dict(tfb.build_fb100_graph(path, **kw),
                         jfb.build_fb100_graph(path, **kw), f"{kw} ")


# ------------------------------------------------------- prepare_datasets


@pytest.mark.parametrize("name", [
    "sync_unrelational", "sync_relational-intra",
    "sync_relational-intra-inter"])
def test_prepare_sync_datasets_match_jax(name):
    assert_same_prepared(tds.prepare_datasets(name, "unused"),
                         jds.prepare_datasets(name, "unused"))


def _twitter_root(root, n=150, dim=310, seed=0):
    rng = np.random.default_rng(seed)
    raw = os.path.join(root, "twitter", "raw")
    os.makedirs(raw)
    y = rng.integers(0, 2, n)
    y[rng.random(n) < 0.1] = -1
    central = rng.random(n) < 0.4
    e = rng.integers(0, n, size=(2, 4 * n))
    np.save(os.path.join(raw, "X.npy"),
            rng.normal(size=(n, dim)).astype(np.float64))
    np.save(os.path.join(raw, "Y.npy"), y)
    np.save(os.path.join(raw, "central_mask.npy"), central)
    np.save(os.path.join(raw, "edge_index.npy"), e)


@pytest.mark.parametrize("name", ["twitter_unrelational",
                                  "twitter_relational"])
def test_prepare_twitter_npy_matches_jax(tmp_path, name):
    _twitter_root(str(tmp_path))
    got = tds.prepare_datasets(name, str(tmp_path))
    assert_same_prepared(got, jds.prepare_datasets(name, str(tmp_path)))
    assert got[1]["x"].shape[1] == 300     # the target's observed prefix


def test_prepare_office_dat_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    n = 140
    central = np.zeros(n, bool)
    central[:80] = True
    r = rng.random(n)
    loops = np.arange(n)
    write_dat(os.path.join(tmp_path, "office_amazon2dslr_pyg.dat"), dict(
        x=rng.normal(size=(n, 9)).astype(np.float32),
        y=rng.integers(0, 4, n),
        edge_index=np.stack([loops, loops]),
        central_mask=central, train_mask=(r < 0.5) & ~central,
        val_mask=(r >= 0.5) & (r < 0.7) & ~central,
        test_mask=(r >= 0.7) & ~central))
    assert_same_prepared(
        tds.prepare_datasets("office_amazon2dslr", str(tmp_path)),
        jds.prepare_datasets("office_amazon2dslr", str(tmp_path)))


def test_prepare_facebook100_mats_match_jax(tmp_path):
    fb = os.path.join(tmp_path, "facebook100")
    os.makedirs(fb)
    make_fake_univ_mat(os.path.join(fb, "Hamilton46.mat"), n=300,
                       num_classes=3, seed=1)
    make_fake_univ_mat(os.path.join(fb, "Caltech36.mat"), n=200,
                       num_classes=3, seed=2)
    got = tds.prepare_datasets("fb_hamilton2caltech", str(tmp_path))
    assert_same_prepared(got, jds.prepare_datasets("fb_hamilton2caltech",
                                                   str(tmp_path)))
    assert got[0]["train_mask"].any() and got[1]["test_mask"].any()


def test_unknown_dataset_raises():
    with pytest.raises(NotImplementedError, match="Not Recognized"):
        tds.prepare_datasets("cora", "unused")
