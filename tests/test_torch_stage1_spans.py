"""PyTorch port, stage 1's profiler ranges (``train/stage1.py``): under a
CPU profiler a scan-mode run with the device sampler and evaluator is one
``stage1.train`` root holding the two preparation ranges, one
``stage1.score`` range per segment, one ``stage1.eval`` range per
evaluation with the pairs it scored, and the best weights' copies with
their bytes; with no profiler nothing is recorded. CPU only; imports no
JAX.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bridged_gnn_tpu_torch.data.datasets import dataset_conversion
from bridged_gnn_tpu_torch.data.synthetic import make_benchmark_graph
from bridged_gnn_tpu_torch.train import stage1 as ts1
from bridged_gnn_tpu_torch.train.device_sampler import DeviceBalancedSampler
from bridged_gnn_tpu_torch.utils.profiling import clear_recorded, recorded

CLASSES = 4


def _domains():
    data = make_benchmark_graph(n=256, avg_degree=4, dim=8,
                                num_classes=CLASSES, seed=3)
    src, tar, _, _ = dataset_conversion(data, seed=3)
    return src, tar


def _cfg():
    # 12 epochs in segments of up to 4, each evaluation epoch (9-12) a
    # segment of its own
    return ts1.Stage1Config(
        hidden_dim=8, num_epoch=12, start_eval_epoch=9, eval_per_epoch=1,
        max_class_num=CLASSES, sample_size=64, eval_sample_size=96,
        scan_epochs=4, device_sampling=True, seed=5)


@pytest.fixture(autouse=True)
def _empty_log():
    clear_recorded()
    yield
    clear_recorded()


def test_a_stage1_run_records_its_ranges_under_one_root():
    src, tar = _domains()
    cfg = _cfg()
    with profile(activities=[ProfilerActivity.CPU]):
        out = ts1.train_adversarial(src, tar, cfg, device="cpu")
    log = recorded()
    assert [s.name for s in log if s.parent is None] == ["stage1.train"]
    root = log[0]
    segments = ts1.segment_bounds(1, cfg)
    assert root.counts == dict(segments=len(segments), evaluations=4)

    def under(name):
        return [(log[s.parent].name if s.parent is not None else None)
                for s in log if s.name == name]

    assert under("stage1.graphs") == ["stage1.train"]
    assert under("stage1.build") == ["stage1.train"]
    assert under("stage1.score") == ["stage1.train"] * len(segments)
    assert under("stage1.eval") == ["stage1.score"] * 4
    # on the CPU every epoch runs eagerly: nothing is captured
    assert under("stage1.capture") == []
    pairs = sum(DeviceBalancedSampler(a, CLASSES, cfg.eval_sample_size,
                                      split, data2=b).num_pairs
                for split in ("val", "test")
                for a, b in ((src, None), (tar, None), (src, tar)))
    assert [s.counts for s in log if s.name == "stage1.eval"] == \
        [dict(pairs=pairs)] * 4
    state_bytes = sum(v.numel() * v.element_size()
                      for v in out["state_dict"].values())
    best = [s for s in log if s.name == "stage1.best"]
    assert (out["best"]["epoch"] > 0) == bool(best)
    assert all(s.parent is not None and log[s.parent].name == "stage1.score"
               and s.counts == dict(bytes=state_bytes) for s in best)
    assert all(root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
               for s in log)
    assert out["total_time"] > 0


def test_a_stage1_run_records_nothing_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    src, tar = _domains()
    ts1.train_adversarial(src, tar, _cfg(), device="cpu")
    assert recorded() == []
