"""Class-balanced pair samplers for stage-1 similarity training.

Port of ``bridged_gnn_tpu/train/samplers.py``, numpy only and copied as
it is, so one ``np.random.Generator`` draws the same pairs in both
packages. Host-side numpy mirrors of the reference enumerators
(models/models.py:265-512):

  * ``PairEnumerator.sampling`` — pick ``max_class_num`` classes, sample
    ``sqrt(sample_size)/max_class_num`` node ids per class per side, emit the
    full cartesian product (models.py:484-512);
  * ``balanced_sampling`` — 50% same-class / 50% cross-class pairs
    (models.py:448-483);
  * the cross-domain variant draws side 1 from source buckets and side 2
    from target buckets (models.py:284-375).

Documented deviations from the reference (SURVEY §7.4 "drop" list): the
``shuffle`` path here actually shuffles both sides coherently (the reference
assigns ``idx2 = idx1[perm]`` — models.py:343,480 — a bug its callers avoid
by passing shuffle=False), and 'all' mode applies the mask with correct
precedence (models.py:306-308 bug).

Pair index arrays have static shapes for a fixed (max_class_num,
sample_size), so the jitted train step compiles once.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _class_buckets(y: np.ndarray, mask: np.ndarray, num_classes: int):
    out = {}
    for c in range(num_classes):
        out[c] = np.where((y == c) & mask)[0]
    return out


def _split_mask(data, mode: str) -> np.ndarray:
    if mode == "train":
        return np.asarray(data["train_mask"])
    if mode == "val":
        return np.asarray(data["val_mask"])
    if mode == "test":
        return np.asarray(data["test_mask"])
    if mode == "all":
        return (
            np.asarray(data["train_mask"])
            | np.asarray(data["val_mask"])
            | np.asarray(data["test_mask"])
        )
    raise NotImplementedError(f"Not Implemented Mode:{mode}")


class PairEnumerator:
    """Within-domain sampler over one split of one graph dict."""

    def __init__(self, data: Dict[str, np.ndarray], mode: str = "train",
                 rng: Optional[np.random.Generator] = None):
        y = np.asarray(data["y"])
        self.num_classes = int(y.max()) + 1
        self.buckets = _class_buckets(y, _split_mask(data, mode), self.num_classes)
        self.rng = rng or np.random.default_rng(0)

    def _select_classes(self, max_class_num: int) -> np.ndarray:
        nonempty = np.array(
            [c for c in range(self.num_classes) if len(self.buckets[c])]
        )
        if len(nonempty) == 0:
            raise ValueError("no class has samples in this split")
        if len(nonempty) > max_class_num:
            return self.rng.choice(nonempty, size=max_class_num,
                                   replace=False)
        return nonempty

    def sampling(self, max_class_num: int = 2, sample_size: int = 10000,
                 shuffle: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        classes = self._select_classes(max_class_num)
        per_class = int(np.sqrt(sample_size) / max_class_num)
        idx1 = np.concatenate([
            self.rng.choice(self.buckets[c], size=per_class) for c in classes
        ])
        idx2 = np.concatenate([
            self.rng.choice(self.buckets[c], size=per_class) for c in classes
        ])
        # cartesian product (pair_enumeration, models.py:265-282)
        n = len(idx1)
        p1 = np.tile(idx1, n)
        p2 = np.repeat(idx2, n)
        if shuffle:
            perm = self.rng.permutation(len(p1))
            p1, p2 = p1[perm], p2[perm]
        return p1, p2

    def balanced_sampling(self, max_class_num: int = 2,
                          sample_size: int = 10000,
                          shuffle: bool = False):
        classes = self._select_classes(max_class_num)
        m = len(classes)
        same = int(0.5 * sample_size / max_class_num)
        diff = (
            int(0.5 * sample_size / (max_class_num * (max_class_num - 1)))
            if max_class_num > 1 else 0
        )
        p1, p2 = [], []
        for c1 in classes:
            for c2 in classes:
                n = same if c1 == c2 else diff
                if n == 0:
                    continue
                p1.append(self.rng.choice(self.buckets[c1], size=n))
                p2.append(self.rng.choice(self.buckets[c2], size=n))
        p1 = np.concatenate(p1)
        p2 = np.concatenate(p2)
        if shuffle:
            perm = self.rng.permutation(len(p1))
            p1, p2 = p1[perm], p2[perm]
        return p1, p2


class PairEnumeratorCross:
    """Cross-domain sampler: side 1 from source buckets, side 2 from target."""

    def __init__(self, data_src, data_tar, mode: str = "train",
                 rng: Optional[np.random.Generator] = None):
        y_src = np.asarray(data_src["y"])
        y_tar = np.asarray(data_tar["y"])
        self.num_classes = int(y_src.max()) + 1
        self.buckets_src = _class_buckets(
            y_src, _split_mask(data_src, mode), self.num_classes
        )
        self.buckets_tar = _class_buckets(
            y_tar, _split_mask(data_tar, mode), self.num_classes
        )
        self.rng = rng or np.random.default_rng(0)

    def _select_classes(self, max_class_num: int) -> np.ndarray:
        nonempty = np.array([
            c for c in range(self.num_classes)
            if len(self.buckets_src[c]) and len(self.buckets_tar[c])
        ])
        if len(nonempty) == 0:
            raise ValueError("no class has samples in both domains")
        if len(nonempty) > max_class_num:
            return self.rng.choice(nonempty, size=max_class_num,
                                   replace=False)
        return nonempty

    def sampling(self, max_class_num: int = 2, sample_size: int = 10000,
                 shuffle: bool = False):
        classes = self._select_classes(max_class_num)
        per_class = int(np.sqrt(sample_size) / max_class_num)
        idx1 = np.concatenate([
            self.rng.choice(self.buckets_src[c], size=per_class)
            for c in classes
        ])
        idx2 = np.concatenate([
            self.rng.choice(self.buckets_tar[c], size=per_class)
            for c in classes
        ])
        n = len(idx1)
        p1 = np.tile(idx1, n)
        p2 = np.repeat(idx2, n)
        if shuffle:
            perm = self.rng.permutation(len(p1))
            p1, p2 = p1[perm], p2[perm]
        return p1, p2

    def balanced_sampling(self, max_class_num: int = 2,
                          sample_size: int = 10000,
                          shuffle: bool = False):
        classes = self._select_classes(max_class_num)
        same = int(0.5 * sample_size / max_class_num)
        diff = (
            int(0.5 * sample_size / (max_class_num * (max_class_num - 1)))
            if max_class_num > 1 else 0
        )
        p1, p2 = [], []
        for c1 in classes:
            for c2 in classes:
                n = same if c1 == c2 else diff
                if n == 0:
                    continue
                p1.append(self.rng.choice(self.buckets_src[c1], size=n))
                p2.append(self.rng.choice(self.buckets_tar[c2], size=n))
        p1 = np.concatenate(p1)
        p2 = np.concatenate(p2)
        if shuffle:
            perm = self.rng.permutation(len(p1))
            p1, p2 = p1[perm], p2[perm]
        return p1, p2


def enumerate_all_pairs(idx1: np.ndarray, idx2: np.ndarray):
    """Full cartesian product in reference pair_enumeration order."""
    p1 = np.tile(idx1, len(idx2))
    p2 = np.repeat(idx2, len(idx1))
    return p1, p2
