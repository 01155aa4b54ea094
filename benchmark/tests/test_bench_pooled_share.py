"""The reader of ``pooled_share.serve`` on hand-made logs of the port's
ranges: the share of requests whose ``serve.copy`` says ``pooled=1``;
nothing where the copies carry no ``pooled`` count (a port from before
the host pool), the log holds no request, or the port is not loaded."""

import sys
from types import SimpleNamespace

import pytest

from lib import spans
from lib.spec import load_metric
from test_bench_spans import MB48, _leaf, _log, _port, _run

NAME = "pooled_share.serve"


def _request(**copy_counts):
    return ("serve.predict", 0.03, {}, [
        _leaf("serve.update", 0.001), _leaf("serve.forward", 0.004),
        _leaf("serve.wait", 0.001),
        _leaf("serve.copy", 0.003, bytes=MB48, **copy_counts)])


def _read(kind="closed_loop"):
    return load_metric(NAME).read(SimpleNamespace(kind=kind, trace=object(),
                                                  window={}))


@pytest.mark.parametrize("pooled,want", [
    ([1, 1, 1, 1], 100.0), ([1, 0, 1, 1], 75.0), ([0, 0], 0.0)])
def test_the_share_of_pooled_copies(monkeypatch, pooled, want):
    # training runs and a lone update in the log are no requests
    _port(monkeypatch, _log(_run(1.0, 0.5, 0.1, [0.01]),
                            *[_request(pooled=p) for p in pooled],
                            _leaf("serve.update", 1.0)))
    assert _read() == pytest.approx(want)


@pytest.mark.parametrize("log", [
    _log(*[_request()] * 3),                    # copies with no count
    _log(_run(1.0, 0.5, 0.1, [0.01])),          # no request
    []])
def test_nothing_without_the_count(monkeypatch, log):
    _port(monkeypatch, log)
    assert _read() is None
    assert _read("train_runs") is None


def test_nothing_without_the_ports_log(monkeypatch):
    monkeypatch.delitem(sys.modules, spans.MODULE, raising=False)
    assert _read() is None
