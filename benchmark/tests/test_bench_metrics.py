"""The metric arithmetic: cost counts against hand counts, roofline and
mfu shares, tails over every request, the idle share of a synthetic
trace, and the modules a run may not load."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from lib import guard, stats
from lib.spec import BENCH, load_json, load_metric, load_module
from lib.trace import Event, TraceSummary, reduce_events

costs = load_module("costs", "ktgnn")
SIZES = dict(n=1000, e=20000, f=256, c=31, h=64, b=2)


def test_attention_counts_by_hand():
    # forward, D=64: 6·64·20000 operations; tables 2·1000·64·2 bytes,
    # domains 1000, senders 4·20000, aggregate 4·1000·64
    assert costs.attention_forward(SIZES, 64) == (
        7_680_000, 256_000 + 1000 + 80_000 + 256_000)
    # backward with its reduce, D=31: plus the cotangent in and two
    # tables out
    assert costs.attention_backward(SIZES, 31) == (
        7_440_000, 124_000 + 1000 + 80_000 + 124_000 + 248_000)
    train = costs.attention_ops(SIZES, "train")
    assert len(train) == 12 and len(costs.attention_ops(SIZES, "serve")) == 4


def test_forward_flops_by_hand():
    n, e = 1000, 20000
    conv = lambda i, o: 4 * n * 2 * i + 4 * n * i * o + 6 * o * e  # noqa
    want = conv(256, 64) + 3 * conv(64, 31) + 4 * n * 64 * 64
    assert costs.forward_flops(SIZES) == want
    assert costs.model_flops(SIZES, "train") == 4 * want
    assert costs.model_flops(SIZES, "serve") == want


def _ctx(kind, trace, **kw):
    return SimpleNamespace(kind=kind, trace=trace, costs=costs,
                           peaks=load_json(BENCH / "peaks.json"),
                           config=load_json(BENCH / "configs/ktgnn.json"),
                           graph=dict(n=1000, e=20000, f=256, c=31), **kw)


def test_roofline_and_mfu_shares():
    peaks = load_json(BENCH / "peaks.json")
    least = costs.attention_least_s(SIZES, "serve", peaks)
    trace = TraceSummary(window_s=1.0, busy_s=0.5, device_ops=10, gaps=[],
                         ops={"void attention_fwd_kernel<16, 1, true, false>"
                              "(int const*)": [4 * least, 8],
                              "elementwise_kernel": [0.1, 2]})
    ctx = _ctx("closed_loop", trace, window=dict(traced=2))
    # two predicts' least time over the kernels' time
    assert load_metric("attention_roofline.serve").read(ctx) \
        == pytest.approx(50.0)
    flops = costs.model_flops(SIZES, "serve") * 2
    assert load_metric("mfu.serve").read(ctx) == pytest.approx(
        100 * flops / 1.0 / peaks["tf32"])
    assert load_metric("idle_share.serve").read(ctx) == 50.0
    # a traced training run counts epochs at the training cost
    train = _ctx("train_runs", trace, window=dict(
        records=[dict(epochs=300, traced=False), dict(epochs=3,
                                                      traced=True)]))
    assert load_metric("mfu.train").read(train) == pytest.approx(
        100 * costs.model_flops(SIZES, "train") * 3 / 1.0 / peaks["tf32"])
    # no kernel of the layer in the trace: nothing to read, never 0
    trace.ops = {"elementwise_kernel": [0.1, 2]}
    assert load_metric("attention_roofline.serve").read(ctx) is None
    # an untraced run reads nothing
    assert load_metric("idle_share.train").read(
        _ctx("train_runs", None)) is None


def test_a_metric_finds_its_own_reader_or_its_familys():
    assert load_metric("epoch_ms.train") is load_module("metrics",
                                                        "epoch_ms.train")
    assert load_metric("mfu.serve") is load_module("metrics", "mfu")


def test_tails_are_over_every_request():
    lat = [0.001] * 94 + [0.010] * 6
    ctx = SimpleNamespace(kind="closed_loop",
                          window=dict(latencies=lat, traced=0))
    assert load_metric("predict_p50_ms").read(ctx) == pytest.approx(1.0)
    assert stats.percentile(lat, 95) == pytest.approx(0.010)
    # between the 94th and 95th of the 100 requests, 0.06 of the way
    assert stats.percentile(lat, 94) == pytest.approx(0.001 + 0.06 * 0.009)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0


def test_idle_share_and_gaps_from_a_synthetic_trace():
    ev = [Event("bench:train_run", 0.0, 10.0, False, True),
          Event("aten::to", 4.0, 6.0, False, False),
          Event("k1", 1.0, 3.0, True, False),
          Event("k2", 2.0, 4.0, True, False),
          Event("k1", 7.0, 8.0, True, False)]
    s = reduce_events(ev, 10.0)
    assert s.busy_s == pytest.approx(4.0)       # [1, 4] and [7, 8]
    assert s.ops["k1"] == [3.0, 2]
    assert s.device_ops == 3
    # gaps: [4, 7] (the host in aten::to), [8, 10], [0, 1]
    assert s.gaps == [
        ("bench:train_run / aten::to", pytest.approx(3.0)),
        ("bench:train_run / host work after aten::to before the end",
         pytest.approx(2.0)),
        ("bench:train_run / host work after the start before aten::to",
         pytest.approx(1.0))]
    assert s.time_of(r"\bk1\b") == (pytest.approx(3.0), 2)


def test_guard_compares_whole_top_level_names():
    mods = ["jax.numpy", "bridged_gnn_tpu.graph", "bridged_gnn_tpu_torch.x",
            "jaxtyping", "flax"]
    assert guard.forbidden(mods) == ["bridged_gnn_tpu.graph", "flax",
                                     "jax.numpy"]


_PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {bench!r}]
{imports}
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(imports):
    code = _PROBE.format(root=str(BENCH.parent), bench=str(BENCH),
                         imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_the_harness_loads_no_jax():
    mods = _loaded(
        "import run\n"
        "from lib.spec import load_module\n"
        "for kind in ('systems', 'checks', 'costs', 'reference'):\n"
        "    load_module(kind, 'ktgnn')\n"
        "import os\n"
        "for f in os.listdir(run.BENCH / 'metrics'):\n"
        "  if f.endswith('.py'):\n"
        "    load_module('metrics', f[:-3])\n")
    assert "bridged_gnn_tpu_torch" in mods
    assert guard.forbidden(mods) == []


def test_the_reference_loads_nothing_of_the_port():
    mods = _loaded("from lib.spec import load_module\n"
                   "load_module('reference', 'ktgnn')\n")
    assert guard.forbidden(mods, guard.FORBIDDEN
                           + ("bridged_gnn_tpu_torch",)) == []
