"""The readers of the port's own profiler ranges (``lib/spans.py`` and
the eight ``program_span`` metrics), on hand-made logs: sums per
training run, medians per request, the copy's rate; nothing where the
log holds no root of the kind, or the port's module is not loaded."""

import sys
from types import SimpleNamespace

import pytest

from lib import spans
from lib.spec import load_metric

TRAIN = ["graph_build_s.stage2", "layout_s.stage2", "capture_ms.train",
         "score_ms.train"]
SERVE = ["launch_ms.serve", "wait_ms.serve", "copy_ms.serve",
         "copy_gbps.serve"]
MB48 = 48_000_000


def _log(*trees):
    """A log from ``(name, seconds, counts, children)`` trees laid end to
    end on the clock, each child after the one before it."""
    out = []

    def add(node, parent, root, t):
        name, secs, counts, children = node
        index = len(out)
        root = index if root is None else root
        span = SimpleNamespace(name=name, start_ns=int(t * 1e9), end_ns=0,
                               parent=parent, root=root, counts=counts)
        out.append(span)
        u = t
        for child in children:
            u = add(child, index, root, u)
        span.end_ns = int((t + secs) * 1e9)
        return t + secs

    t = 0.0
    for tree in trees:
        t = add(tree, None, None, t)
    return out


def _leaf(name, secs, **counts):
    return (name, secs, counts, [])


def _run(graph, layout, capture, scores):
    return ("stage2.train", 10.0, {}, [
        _leaf("stage2.graph", graph), _leaf("stage2.layout", layout),
        _leaf("stage2.capture", capture)]
        + [_leaf("stage2.score", s) for s in scores])


def _request(update, forward, wait, copy):
    kids = [] if update is None else [_leaf("serve.update", update)]
    return ("serve.predict", 0.05, {}, kids + [
        _leaf("serve.forward", forward), _leaf("serve.wait", wait),
        _leaf("serve.copy", copy, bytes=MB48)])


LOG = _log(
    _run(2.0, 1.5, 0.2, [0.01, 0.02]), _run(1.0, 0.5, 0.1, [0.03]),
    _request(0.001, 0.004, 0.002, 0.024),
    _request(0.002, 0.005, 0.001, 0.026),
    _request(None, 0.003, 0.003, 0.025),
    # a feature update outside any request is a root of its own
    _leaf("serve.update", 1.0))


def _port(monkeypatch, log):
    module = SimpleNamespace(recorded=lambda: list(log))
    monkeypatch.setitem(sys.modules, spans.MODULE, module)


def _ctx(kind):
    return SimpleNamespace(kind=kind, trace=object(), window={})


@pytest.mark.parametrize("name,want", [
    ("graph_build_s.stage2", 1.5), ("layout_s.stage2", 1.0),
    ("capture_ms.train", 150.0), ("score_ms.train", 30.0),
    ("launch_ms.serve", 5.0), ("wait_ms.serve", 2.0),
    ("copy_ms.serve", 25.0), ("copy_gbps.serve", 3 * MB48 / 0.075 / 1e9)])
@pytest.mark.parametrize("kind", ["train_runs", "closed_loop"])
def test_each_reader_reads_its_ranges(monkeypatch, name, want, kind):
    _port(monkeypatch, LOG)
    assert load_metric(name).read(_ctx(kind)) == pytest.approx(want,
                                                               rel=1e-6)


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_no_root_of_its_kind_reads_nothing(monkeypatch, name):
    train_only = [s for s in LOG if LOG[s.root].name == "stage2.train"]
    serve_only = _log(*[_request(0.001, 0.004, 0.002, 0.024)] * 2)
    _port(monkeypatch, serve_only if name in TRAIN else train_only)
    assert load_metric(name).read(_ctx("train_runs")) is None
    _port(monkeypatch, [])
    assert load_metric(name).read(_ctx("closed_loop")) is None


def test_roots_group_a_log_by_its_root_ranges(monkeypatch):
    _port(monkeypatch, LOG)
    runs = spans.roots("stage2.train")
    assert [len(r) for r in runs] == [6, 5]
    assert [r[0].name for r in runs] == ["stage2.train"] * 2
    assert len(spans.roots("serve.predict")) == 3
    assert spans.per_root("serve.predict", "serve.update") == \
        pytest.approx([0.001, 0.002, 0.0])
    assert spans.per_root("serve.predict", "stage2.graph") is None


@pytest.mark.parametrize("module", [None, SimpleNamespace()])
def test_nothing_without_the_ports_log(monkeypatch, module):
    """The port not loaded, or loaded without a log of its ranges (a
    program from before it kept one)."""
    if module is None:
        monkeypatch.delitem(sys.modules, spans.MODULE, raising=False)
    else:
        monkeypatch.setitem(sys.modules, spans.MODULE, module)
    assert spans.log() == []
    for name in TRAIN + SERVE:
        assert load_metric(name).read(_ctx("closed_loop")) is None
