"""Class-balanced pair sampling on the device for stage-1 training.

Port of ``bridged_gnn_tpu/train/device_sampler.py``. The class buckets go
to the device once, as a padded ``[classes, max_bucket]`` matrix, and
each epoch's pairs are drawn there from a ``torch.Generator`` on that
device: in scan mode the whole epoch, sampling included, is one replay
of a CUDA graph, with nothing copied from the host.

Semantics are ``PairEnumerator.sampling``'s (reference
models.py:484-512): pick ``min(#nonempty, max_class_num)`` classes (a
uniform subset without replacement when over the cap), draw
``int(sqrt(sample_size) / max_class_num)`` node ids per class per side
uniformly with replacement, and emit the full cartesian product in
``pair_enumeration`` order (tile × repeat, models.py:265-282).
:class:`DeviceBalancedSampler` is ``balanced_sampling``'s counterpart
(models.py:448-483), with JAX's static ``(c1, c2)`` slot pattern.

The streams are torch's, not numpy's and not ``jax.random``'s: pair
distributions match the host sampler's, streams do not (the JAX package
documents this knob the same way). The class subset is the argsort of
uniform draws, which is a uniform subset, where JAX takes a
``jax.random.permutation``: ``torch.randperm`` on a card generator may
not be captured in a CUDA graph. Every draw here is capturable: fixed
shapes, no host sync.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bridged_gnn_tpu_torch.train.samplers import _class_buckets, _split_mask

Tensor = torch.Tensor


def _bucket_matrix(buckets: Dict[int, np.ndarray], keep: np.ndarray,
                   device) -> Tuple[Tensor, Tensor]:
    """Per-class index lists padded to a ``[len(keep), max_bucket]``
    int64 matrix, and their sizes."""
    max_bucket = max(int(len(buckets[c])) for c in keep)
    ids = np.zeros((len(keep), max_bucket), dtype=np.int64)
    sizes = np.zeros(len(keep), dtype=np.int64)
    for row, c in enumerate(keep):
        b = buckets[c]
        ids[row, : len(b)] = b
        sizes[row] = len(b)
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(sizes).to(device))


def _build_buckets(data, data2, mode: str):
    """Per-class buckets of one domain, or with ``data2`` of a
    cross-domain pair, whose usable classes are those nonempty in both
    (reference models.py:284-375). Returns ``(buckets1, buckets2,
    nonempty)``."""
    y = np.asarray(data["y"])
    num_classes = int(y.max()) + 1
    b1 = _class_buckets(y, _split_mask(data, mode), num_classes)
    if data2 is not None:
        y2 = np.asarray(data2["y"])
        b2 = _class_buckets(y2, _split_mask(data2, mode), num_classes)
        nonempty = np.array([
            c for c in range(num_classes) if len(b1[c]) and len(b2[c])])
        if len(nonempty) == 0:
            raise ValueError("no class has samples in both domains")
    else:
        b2 = b1
        nonempty = np.array([c for c in range(num_classes) if len(b1[c])])
        if len(nonempty) == 0:
            raise ValueError("no class has samples in this split")
    return b1, b2, nonempty


class _BucketSampler:
    """What both samplers share: the bucket matrices of both sides, the
    class-subset draw and the per-slot id draw."""

    def __init__(self, data, max_class_num: int, mode: str, data2, device):
        b1, b2, nonempty = _build_buckets(data, data2, mode)
        self.num_nonempty = len(nonempty)
        self.m = min(self.num_nonempty, max_class_num)
        self.classes = nonempty
        self.ids1, self.sizes1 = _bucket_matrix(b1, nonempty, device)
        self.ids2, self.sizes2 = (
            (self.ids1, self.sizes1) if data2 is None
            else _bucket_matrix(b2, nonempty, device))
        self.device = self.ids1.device

    def _rows(self, gen: torch.Generator) -> Tensor:
        """The bucket rows of this draw's classes: all of them under the
        cap, else a uniform subset of ``m`` (the first ``m`` of a random
        order)."""
        if self.num_nonempty <= self.m:
            return torch.arange(self.m, device=self.device)
        u = torch.rand(self.num_nonempty, generator=gen,
                       device=self.device)
        return u.argsort()[: self.m]

    @staticmethod
    def _draw(gen, ids: Tensor, sizes: Tensor, rows: Tensor) -> Tensor:
        """One id uniformly with replacement from bucket ``rows[j]`` for
        each j, as JAX's ``_draw``: ``min(floor(u · size), size - 1)``."""
        size = sizes[rows]
        u = torch.rand(rows.shape, generator=gen, device=ids.device)
        col = torch.minimum((u * size.float()).long(), size - 1)
        return ids[rows, col]


class DevicePairSampler(_BucketSampler):
    """``PairEnumerator.sampling`` on the device (reference
    models.py:484-512). Side 1 draws from ``data``'s buckets; with
    ``data2``, side 2 from ``data2``'s (``PairEnumeratorCross``,
    models.py:284-375).

    ``sample(gen)`` returns ``(pair1, pair2)`` int64 tensors of static
    length ``(per_class · m)²``, the host sampler's shape for the same
    config."""

    def __init__(self, data: Dict[str, np.ndarray], max_class_num: int,
                 sample_size: int, mode: str = "train",
                 data2: Optional[Dict[str, np.ndarray]] = None,
                 device="cpu"):
        super().__init__(data, max_class_num, mode, data2, device)
        self.per_class = int(np.sqrt(sample_size) / max_class_num)
        if self.per_class < 1:
            raise ValueError(f"sample_size {sample_size} too small for "
                             f"max_class_num {max_class_num}")

    @property
    def num_pairs(self) -> int:
        return (self.per_class * self.m) ** 2

    def sample(self, gen: torch.Generator) -> Tuple[Tensor, Tensor]:
        slots = self._rows(gen).repeat_interleave(self.per_class)
        idx1 = self._draw(gen, self.ids1, self.sizes1, slots)
        idx2 = self._draw(gen, self.ids2, self.sizes2, slots)
        # pair_enumeration order: idx1 tiled, idx2 repeated
        n = idx1.shape[0]
        return idx1.repeat(n), idx2.repeat_interleave(n)


def DevicePairSamplerCross(data_src, data_tar, max_class_num: int,
                           sample_size: int, mode: str = "train",
                           device="cpu") -> DevicePairSampler:
    """Side 1 from the source's buckets, side 2 from the target's."""
    return DevicePairSampler(data_src, max_class_num, sample_size, mode,
                             data2=data_tar, device=device)


class DeviceBalancedSampler(_BucketSampler):
    """``balanced_sampling`` on the device (reference models.py:448-483):
    for every ordered pair of selected classes ``(c1, c2)``, ``same``
    pairs when ``c1 == c2`` else ``diff``, with ``same = int(0.5 ·
    sample_size / max_class_num)`` and ``diff = int(0.5 · sample_size /
    (max_class_num · (max_class_num − 1)))`` from the argument
    ``max_class_num``, as the host sampler computes them. The slot
    pattern (``slots1``, ``slots2``: the class slot of each pair's sides)
    is static, JAX's ``_slots1``/``_slots2``; a draw maps slots to its
    classes. ``data2``: the cross variant's second domain."""

    def __init__(self, data: Dict[str, np.ndarray], max_class_num: int,
                 sample_size: int, mode: str = "train",
                 data2: Optional[Dict[str, np.ndarray]] = None,
                 device="cpu"):
        super().__init__(data, max_class_num, mode, data2, device)
        same = int(0.5 * sample_size / max_class_num)
        diff = (int(0.5 * sample_size / (max_class_num * (max_class_num - 1)))
                if max_class_num > 1 else 0)
        r1, r2 = [], []
        for i in range(self.m):
            for j in range(self.m):
                n = same if i == j else diff
                r1.append(np.full(n, i, dtype=np.int64))
                r2.append(np.full(n, j, dtype=np.int64))
        slots1, slots2 = np.concatenate(r1), np.concatenate(r2)
        if len(slots1) == 0:
            raise ValueError(f"sample_size {sample_size} too small for "
                             f"max_class_num {max_class_num}")
        self.slots1 = torch.from_numpy(slots1).to(self.device)
        self.slots2 = torch.from_numpy(slots2).to(self.device)

    @property
    def num_pairs(self) -> int:
        return int(self.slots1.shape[0])

    def sample(self, gen: torch.Generator) -> Tuple[Tensor, Tensor]:
        rows = self._rows(gen)
        return (self._draw(gen, self.ids1, self.sizes1, rows[self.slots1]),
                self._draw(gen, self.ids2, self.sizes2, rows[self.slots2]))


def build_device_samplers(src_d: Dict[str, np.ndarray],
                          tar_d: Dict[str, np.ndarray], max_class_num: int,
                          sample_size: int, device="cpu"):
    """The three train-split samplers of the stage-1 step, and both
    domains' labels on ``device`` for the pair targets."""
    samplers = dict(
        src=DevicePairSampler(src_d, max_class_num, sample_size,
                              device=device),
        tar=DevicePairSampler(tar_d, max_class_num, sample_size,
                              device=device),
        cross=DevicePairSamplerCross(src_d, tar_d, max_class_num,
                                     sample_size, device=device),
    )
    labels = {name: torch.from_numpy(np.asarray(d["y"]).astype(np.int64)
                                     ).to(device)
              for name, d in (("src", src_d), ("tar", tar_d))}
    return samplers, labels


def pair_targets(labels: Dict[str, Tensor], idxs: Dict[str, Tensor]
                 ) -> Dict[str, Tensor]:
    """The f32 targets of an epoch's pairs: 1 where both ends share a
    label."""
    ys, yt = labels["src"], labels["tar"]
    return dict(
        src=(ys[idxs["src1"]] == ys[idxs["src2"]]).float(),
        tar=(yt[idxs["tar1"]] == yt[idxs["tar2"]]).float(),
        cross=(ys[idxs["cross1"]] == yt[idxs["cross2"]]).float(),
    )


def sample_epoch_on_device(samplers: Dict, labels: Dict[str, Tensor],
                           gen: torch.Generator):
    """One epoch's pair indices and targets, drawn from ``gen`` on its
    device: ``(idxs, y_pairs)`` in the host ``sample_epoch``'s layout, so
    the step functions are shared between the two paths."""
    s1, s2 = samplers["src"].sample(gen)
    t1, t2 = samplers["tar"].sample(gen)
    c1, c2 = samplers["cross"].sample(gen)
    idxs = dict(src1=s1, src2=s2, tar1=t1, tar2=t2, cross1=c1, cross2=c2)
    return idxs, pair_targets(labels, idxs)
