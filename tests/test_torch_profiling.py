"""PyTorch port, the program's profiler ranges (``utils/profiling.py``):
``annotate`` does nothing with no profiler running and, under one, opens a
``record_function`` range and keeps it in ``recorded()``'s log, under its
parent; the ranges of a stage-2 training run and of a KT-GNN request;
``EpochTimer``'s summary. CPU only; imports no JAX.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bridged_gnn_tpu_torch.data import synthetic as tsyn
from bridged_gnn_tpu_torch.serve import KTGNNPredictor
from bridged_gnn_tpu_torch.train.stage2 import (
    Stage2Config,
    build_model,
    train_ktgnn,
)
from bridged_gnn_tpu_torch.utils import profiling
from bridged_gnn_tpu_torch.utils.profiling import (
    EpochTimer,
    annotate,
    clear_recorded,
    recorded,
)

CLASSES = 3
# scan mode on the CPU runs every epoch eagerly: no capture range
TRAIN_SPANS = ["stage2.train", "stage2.graph", "stage2.layout",
               "stage2.score", "stage2.score"]
PREDICT_SPANS = ["serve.predict", "serve.update", "serve.forward",
                 "serve.wait", "serve.copy"]


def _data():
    data = tsyn.make_sync_dataset("relational-intra", n_src=90, n_tar=60,
                                  dim=12, num_classes=CLASSES, seed=1)
    r = np.random.default_rng(1).random(150)
    data["train_mask"] = r < 0.6
    data["val_mask"] = (r >= 0.6) & (r < 0.8)
    data["test_mask"] = r >= 0.8
    return data


def _cfg():
    return Stage2Config(num_epoch=3, scan_epochs=2, hidden=8, lr=1e-2,
                        log_every=0)


def _requests(pred, data, count=2):
    rng = np.random.default_rng(0)
    n, d = data["x"].shape
    for _ in range(count):
        nodes = rng.choice(n, size=5, replace=False)
        pred.predict_live(x=rng.normal(size=(5, d)).astype(np.float32),
                          nodes=nodes)


def _predictor(data):
    model = build_model(Stage2Config(hidden=8), CLASSES, data["x"].shape[1],
                        "cpu")
    return KTGNNPredictor(model, None, dict(data), device="cpu")


@pytest.fixture(autouse=True)
def _empty_log():
    clear_recorded()
    yield
    clear_recorded()


def _roots(log):
    """Each root's ranges, in order, as (name, parent's name)."""
    out = {}
    for s in log:
        parent = None if s.parent is None else log[s.parent].name
        out.setdefault(s.root, []).append((s.name, parent))
    return list(out.values())


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    data = _data()
    train_ktgnn(data, _cfg(), device="cpu")
    _requests(_predictor(data), data)
    with annotate("probe", bytes=4):
        pass
    assert recorded() == []


def test_a_training_run_records_its_ranges_under_one_root():
    data = _data()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_ktgnn(data, _cfg(), device="cpu")
    log = recorded()
    assert _roots(log) == [[(TRAIN_SPANS[0], None)]
                           + [(n, "stage2.train") for n in TRAIN_SPANS[1:]]]
    assert all(s.end_ns >= s.start_ns for s in log)
    root = log[0]
    assert all(root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
               for s in log)
    # the profiler's own events hold the same ranges
    names = {e.key for e in prof.key_averages()}
    assert set(TRAIN_SPANS) <= names


def test_each_request_is_a_root_and_the_copy_counts_its_bytes():
    data = _data()
    pred = _predictor(data)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _requests(pred, data)
        pred.predict()
    log = recorded()
    parented = [(PREDICT_SPANS[0], None)] + [
        (n, "serve.predict") for n in PREDICT_SPANS[1:]]
    # predict() updates no rows
    assert _roots(log) == [parented, parented,
                           [p for p in parented if p[0] != "serve.update"]]
    n = data["x"].shape[0]
    copies = [s for s in log if s.name == "serve.copy"]
    assert [s.counts for s in copies] == \
        [dict(bytes=3 * n * CLASSES * 4, pooled=1)] * 3
    assert all(s.counts == {} for s in log if s.name != "serve.copy")
    names = {e.key for e in prof.key_averages()}
    assert set(PREDICT_SPANS) <= names


def test_ranges_nest_and_the_log_clears():
    with profile(activities=[ProfilerActivity.CPU]):
        with annotate("a"):
            with annotate("b", rows=2):
                pass
            with annotate("c"):
                pass
        with annotate("d"):
            pass
    log = recorded()
    assert [(s.name, s.parent, s.root, s.counts) for s in log] == [
        ("a", None, 0, {}), ("b", 0, 0, dict(rows=2)), ("c", 0, 0, {}),
        ("d", None, 3, {})]
    assert recorded() is not profiling._LOG
    clear_recorded()
    assert recorded() == []


def test_epoch_timer_summary_holds_what_is_read():
    timer = EpochTimer("cpu", warmup=1)
    for k in (1, 2):
        with timer.chunk(k):
            pass
    s = timer.summary()
    assert set(s) == {"mean_s", "p50_s", "steps", "steady_steps"}
    assert (s["steps"], s["steady_steps"]) == (3, 2)


def test_counts_set_before_a_range_closes_are_kept():
    with profile(activities=[ProfilerActivity.CPU]):
        with annotate("a", rows=1) as span:
            span.counts.update(pairs=6)
    assert [(s.name, s.counts) for s in recorded()] == [
        ("a", dict(rows=1, pairs=6))]
    clear_recorded()
    # with no profiler the counts go nowhere
    with annotate("b") as span:
        span.counts.update(pairs=6)
    assert recorded() == []
