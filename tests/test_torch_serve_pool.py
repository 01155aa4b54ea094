"""PyTorch port, the predictor's host buffers (``serve.py::HostPool``):
an answer is the caller's while any of its arrays is held, and later
requests leave it as it was; a dropped answer's buffer serves the next
request; past ``POOL_BUFFERS`` held answers a request copies to a fresh
array, alike, and its ``serve.copy`` range says ``pooled=0``; heads of
another shape get buffers of their own; threads never share one. CPU
only; imports no JAX.
"""

import os
import random
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bridged_gnn_tpu_torch.data import synthetic as tsyn
from bridged_gnn_tpu_torch.serve import (
    POOL_BUFFERS,
    HostPool,
    KTGNNPredictor,
)
from bridged_gnn_tpu_torch.train.stage2 import Stage2Config, build_model
from bridged_gnn_tpu_torch.utils.profiling import clear_recorded, recorded

CLASSES, ROWS = 3, 5
HEADS = ("source", "target", "target_hat")


@pytest.fixture(scope="module")
def data():
    return tsyn.make_sync_dataset("relational-intra", n_src=60, n_tar=40,
                                  dim=12, num_classes=CLASSES, seed=3)


def _predictor(data, classes=CLASSES):
    model = build_model(Stage2Config(hidden=8), classes, data["x"].shape[1],
                        "cpu")
    return KTGNNPredictor(model, None, dict(data), device="cpu")


def _request(data, seed):
    rng = np.random.default_rng(seed)
    n, d = data["x"].shape
    return dict(x=rng.normal(size=(ROWS, d)).astype(np.float32),
                nodes=rng.choice(n, size=ROWS, replace=False))


def _key(data, classes=CLASSES):
    """The pool's key of the heads: three heads over every node."""
    return ((3, data["x"].shape[0], classes), torch.float32)


def _address(answer):
    return answer["source"].__array_interface__["data"][0]


def _assert_same(got, want):
    for head in HEADS:
        np.testing.assert_array_equal(got[head], want[head], err_msg=head)


def test_a_kept_answer_outlives_later_requests(data):
    pred = _predictor(data)
    req_a = _request(data, 0)
    a = pred.predict_live(**req_a)
    frozen = {h: a[h].copy() for h in HEADS}
    b = pred.predict_live(**_request(data, 1))
    c = pred.predict_live(**_request(data, 2))
    # the three answers live in three buffers, and differ
    assert len({_address(r) for r in (a, b, c)}) == 3
    assert not np.array_equal(a["target_hat"], b["target_hat"])
    _assert_same(a, frozen)
    _assert_same(a, pred.predict_live(**req_a))
    assert pred.host_pool.counts()[_key(data)][0] >= 3


def test_a_dropped_answer_gives_its_buffer_to_the_next_request(data):
    pred = _predictor(data)
    key = _key(data)
    first = pred.predict_live(**_request(data, 0))
    address = _address(first)
    assert pred.host_pool.counts() == {key: (1, 0)}
    # one array of the answer still holds the buffer
    head = first["target"]
    del first
    assert pred.host_pool.counts() == {key: (1, 0)}
    del head
    assert pred.host_pool.counts() == {key: (1, 1)}
    second = pred.predict_live(**_request(data, 1))
    assert _address(second) == address
    assert pred.host_pool.counts() == {key: (1, 0)}
    # an answer from predict() and predict_labels() alike
    del second
    pred.predict_labels()
    assert pred.host_pool.counts() == {key: (1, 1)}


def test_past_the_bound_a_request_falls_back_and_says_so(data):
    pred = _predictor(data)
    key = _key(data)
    held = [pred.predict_live(**_request(data, i))
            for i in range(POOL_BUFFERS)]
    assert pred.host_pool.counts() == {key: (POOL_BUFFERS, 0)}
    req = _request(data, 99)
    clear_recorded()
    with profile(activities=[ProfilerActivity.CPU]):
        extra = pred.predict_live(**req)
        held.pop()      # one buffer back: the next request takes it
        again = pred.predict_live(**req)
    copies = [s.counts for s in recorded() if s.name == "serve.copy"]
    clear_recorded()
    n = data["x"].shape[0]
    assert copies == [dict(bytes=3 * n * CLASSES * 4, pooled=0),
                      dict(bytes=3 * n * CLASSES * 4, pooled=1)]
    # the fallback's answer is its own array, and alike
    assert _address(extra) not in {_address(r) for r in held + [again]}
    _assert_same(extra, again)
    assert pred.host_pool.counts() == {key: (POOL_BUFFERS, 0)}
    # the pool never grows past its bound
    more = pred.predict_live(**req)
    _assert_same(more, again)
    assert pred.host_pool.counts() == {key: (POOL_BUFFERS, 0)}


def test_heads_of_another_class_count_get_their_own_buffers(data):
    pred = _predictor(data)
    three = pred.predict()
    frozen = {h: three[h].copy() for h in HEADS}
    pred.model = build_model(Stage2Config(hidden=8), CLASSES + 2,
                             data["x"].shape[1], "cpu").eval()
    five = pred.predict()
    assert five["target_hat"].shape == (data["x"].shape[0], CLASSES + 2)
    assert pred.host_pool.counts() == {_key(data): (1, 0),
                                       _key(data, CLASSES + 2): (1, 0)}
    _assert_same(three, frozen)
    del three
    assert pred.host_pool.counts()[_key(data)] == (1, 1)
    assert pred.host_pool.counts()[_key(data, CLASSES + 2)] == (1, 0)


def test_threads_taking_and_dropping_never_share_a_buffer():
    """Threads, more than the cores, take buffers, mark them, hold a few
    and drop them in any order, with leases ending on every thread: no
    buffer is lent twice at once (each held array keeps its holder's
    mark), the pool stays within its bound and gets every buffer back."""
    pool = HostPool()
    shape, dtype = (3, 8, 4), torch.float32
    threads, rounds = 2 * (os.cpu_count() or 4), 200
    wrong, fallbacks = [], []

    def work(mark):
        rng = random.Random(mark)
        held = []
        for _ in range(rounds):
            lent = pool.take(shape, dtype, pin=False)
            if lent is None:
                fallbacks.append(mark)
            else:
                lent[1][...] = mark
                held.append(lent[1])
            while held and (len(held) > 2 or rng.random() < 0.5):
                arr = held.pop(rng.randrange(len(held)))
                if not (arr == mark).all():
                    wrong.append(mark)
        if any(not (arr == mark).all() for arr in held):
            wrong.append(mark)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work, args=(m,))
                   for m in range(1, threads + 1)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers)
    assert wrong == []
    assert fallbacks, "the bound was never reached"
    assert pool.counts() == {((3, 8, 4), dtype): (POOL_BUFFERS,
                                                  POOL_BUFFERS)}
