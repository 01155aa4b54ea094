"""PyTorch port, bf16 messages and matmul precision (the JAX package's
production stage-2 recipe; mirrors tests/test_message_dtype.py): the bf16
model drifts little from the f32 one and matches the JAX bf16 model, the
plain versions take bf16 tables, gradients come back in each input's
dtype, the trainer and both CLIs run ``message_dtype="bfloat16"`` and
``matmul_precision``, and the names they do not take raise. CPU only; the
bf16 kernels on the card are in tests/test_torch_cuda.py."""

import json
import pickle
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from bridged_gnn_tpu.graph import graph_from_dict as j_graph_from_dict
from bridged_gnn_tpu.graph import with_self_loops as j_with_self_loops
from bridged_gnn_tpu.io.serialize import save_graph_npz
from bridged_gnn_tpu.ops.spmm import adjacency_from_graph as j_adj

from bridged_gnn_tpu_torch.cli import main_graph_knowledge_transfer as tcli2
from bridged_gnn_tpu_torch.cli import serve as tcli
from bridged_gnn_tpu_torch.graph import graph_from_dict, with_self_loops
from bridged_gnn_tpu_torch.io.flax_weights import (
    flax_variables_from_state_dict,
    state_dict_from_flax,
)
from bridged_gnn_tpu_torch.nn import ktgnn as tk
from bridged_gnn_tpu_torch.nn.ktgnn import KTGNN, AdaptedConv
from bridged_gnn_tpu_torch.ops import fused_kernels as fk
from bridged_gnn_tpu_torch.ops.fused_attention import (
    AttentionCat,
    AttentionSel,
)
from bridged_gnn_tpu_torch.ops.spmm import adjacency_from_graph
from bridged_gnn_tpu_torch.serve import KTGNNPredictor
from bridged_gnn_tpu_torch.train import stage2 as ts2
from bridged_gnn_tpu_torch.train.stage2 import (
    Stage2Config,
    build_model,
    train_ktgnn,
)
from bridged_gnn_tpu_torch.utils.platform import matmul_precision

from tests.test_torch_cuda import (
    SLOPE,
    _all_calls,
    _hub_layout,
    _small_layout,
    skewed_data,
)
from tests.test_torch_graph import sync_data
from tests.test_torch_ktgnn import CLASSES, DIM, HIDDEN, _jax_variables

BF16 = torch.bfloat16
# One bf16 rounding moves a value by at most 2^-8 of its magnitude (8
# significant bits, round to nearest). The two models round their messages
# at different points (JAX also rounds each weighted message before its
# one-hot sum), so their log-probabilities may differ by about two such
# roundings of the largest.
BF16_ROUND = 2.0 ** -8


def _graph(rng, n=300, e=1800, d=24, c=4):
    """tests/test_message_dtype.py's graph."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, c, size=n)
    central = np.zeros(n, bool)
    central[: n // 2] = True
    r = rng.random(n)
    return dict(
        x=x, edge_index=rng.integers(0, n, size=(2, e)), y=y,
        train_mask=r < 0.6, val_mask=(r >= 0.6) & (r < 0.8),
        test_mask=r >= 0.8, central_mask=central,
    )


@pytest.mark.parametrize("method", ["blocked", "tiered"])
def test_forward_drift_small_vs_f32(rng, method):
    """The bf16 model against the f32 one with the same weights: every
    log-probability within 0.15 and the argmax equal on more than 98% of
    the nodes, as the JAX package's test holds its bf16 model."""
    g = with_self_loops(graph_from_dict(_graph(rng)))
    adj = adjacency_from_graph(g, method=method, node_block=128,
                               device="cpu")
    assert (adj.tiered_fn is not None) == (method == "tiered")
    cfg = Stage2Config(hidden=16, dropout=0.0)
    m32 = build_model(cfg, 4, 24, device="cpu").eval()
    m16 = build_model(Stage2Config(hidden=16, dropout=0.0,
                                   message_dtype="bfloat16"), 4, 24,
                      device="cpu").eval()
    m16.load_state_dict(m32.state_dict())
    with torch.inference_mode():
        lp32, lp16 = m32(g, adj)[0], m16(g, adj)[0]
    assert lp16.dtype == torch.float32
    nm = g.node_mask
    drift = (lp32 - lp16).abs()[nm]
    agree = (lp32.argmax(1) == lp16.argmax(1))[nm].float().mean()
    print(f"{method}: drift {float(drift.max()):.4g}, argmax agreement "
          f"{float(agree):.4f}")
    assert 0 < float(drift.max()) < 0.15
    assert float(agree) > 0.98


@pytest.mark.parametrize("case,method", [("sync", "blocked"),
                                         ("skew", "blocked"),
                                         ("skew", "tiered")])
def test_bf16_model_matches_jax(case, method):
    """The port's bf16 KT-GNN against the JAX bf16 model on the same numpy
    inputs and converted weights, the JAX side on its kernel forward in
    interpret mode under ``jax.default_matmul_precision("default")``.
    Tolerance: two bf16 roundings (2·2^-8) of the largest log-probability;
    argmax equal on more than 98% of the nodes."""
    data = (sync_data(dim=DIM, num_classes=CLASSES) if case == "sync"
            else skewed_data(np.random.default_rng(5), n=160, c=CLASSES,
                             d=DIM))
    jmodel, variables = _jax_variables(data, seed=0 if case == "sync" else 1)
    gj = j_with_self_loops(j_graph_from_dict(dict(data)))
    aj = j_adj(gj, method=method, node_block=128)
    with jax.default_matmul_precision("default"):
        want = jmodel.clone(fused_kernel_fwd=True, select_gather=True,
                            msg_dtype="bfloat16").apply(variables, gj, aj,
                                                        False)
    g = with_self_loops(graph_from_dict(dict(data)))
    adj = adjacency_from_graph(g, method=method, node_block=128,
                               device="cpu")
    assert (adj.tiered_fn is None) == (aj.tiered_fn is None)
    model = build_model(Stage2Config(hidden=HIDDEN,
                                     message_dtype="bfloat16"), CLASSES,
                        DIM, device="cpu")
    model.load_state_dict(state_dict_from_flax(model, variables),
                          strict=True)
    with torch.inference_mode():
        got = model.eval()(g, adj)
    nm = np.asarray(gj.node_mask)
    for g_, w_ in zip(got, want[:3]):
        g_, w_ = g_.numpy()[nm], np.asarray(w_)[nm]
        tol = 2 * BF16_ROUND * float(np.abs(w_).max())
        err = float(np.abs(g_ - w_).max())
        agree = float((g_.argmax(1) == w_.argmax(1)).mean())
        print(f"{case} {method}: max |port - JAX| {err:.4g} (tolerance "
              f"{tol:.4g}), argmax agreement {agree:.4f}")
        assert err <= tol
        assert agree > 0.98


def _bf16_calls(rng, lay, d):
    """:func:`_all_calls` with the tables (and the reduce's rows) in bf16,
    and the same calls on those values widened to f32."""
    calls16, calls32 = [], []
    for wrapper, args in _all_calls(rng, lay, d):
        if wrapper is fk.slot_reduce:
            idx = (1,)
        else:
            idx = (1, 2, 3)
        a16 = list(args)
        for i in idx:
            a16[i] = args[i].to(BF16)
        a32 = [a.float() if i in idx else a for i, a in enumerate(a16)]
        calls16.append((wrapper, tuple(a16)))
        calls32.append((wrapper, tuple(a32)))
    return calls16, calls32


@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("layout", ["small", "hub"])
def test_plain_versions_take_bf16(rng, layout, d):
    """Each plain version (a wrapper given CPU tensors runs it) on bf16
    tables equals the same function in f32 on those values widened, at
    1e-5; the backwards' dm is that f32 dm rounded to bf16, and every
    other output is f32."""
    lay = (_small_layout if layout == "small" else _hub_layout)(rng)
    for (wrapper, a16), (_, a32) in zip(*_bf16_calls(rng, lay, d)):
        got = wrapper(*a16)
        want = wrapper(*a32)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        is_bwd = wrapper in (fk.attention_sel_bwd, fk.attention_bwd)
        for i, (g_, w_) in enumerate(zip(got, want)):
            if is_bwd and i == 0:
                assert g_.dtype == BF16
                assert torch.equal(g_, w_.to(BF16)), wrapper.__name__
            elif g_.dtype == torch.uint8:
                assert torch.equal(g_, w_)
            else:
                assert g_.dtype == torch.float32
                torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5)


def test_wrappers_check_message_dtypes(rng):
    """The tables of one call share float32 or bfloat16; the logit vectors
    stay float32 (the checks the wrappers run on card tensors)."""
    lay = _small_layout(rng)
    (_, args), = [c for c in _all_calls(rng, lay, 8, n_in=64)
                  if c[0] is fk.attention_sel_fwd]
    _, u1, u2, ud, c, a1, a2, _ = args
    fk._check_inputs(lay, u1.to(BF16), u2.to(BF16), ud.to(BF16), c, a1, a2)
    for bad in ((u1.to(BF16), u2, ud, c, a1, a2),
                (u1.half(), u2.half(), ud.half(), c, a1, a2),
                (u1.to(BF16), u2.to(BF16), ud.to(BF16), c, a1.to(BF16), a2)):
        with pytest.raises(TypeError):
            fk._check_inputs(lay, *bad)
    assert fk.launch_key(64, torch.float32) == 64
    assert fk.launch_key(64, BF16) == "64:bf16"


@pytest.mark.parametrize("fn", [AttentionSel, AttentionCat])
def test_bf16_gradients_finite_and_typed(rng, fn):
    """The attention Functions on bf16 tables: the output in bf16, the
    gradients finite and in each input's dtype (bf16 for u1, u2, ud, f32
    for a1, a2) and equal to the f32 Function's on the widened values
    within bf16 rounding."""
    lay = _hub_layout(rng)
    (_, args), = [c for c in _all_calls(rng, lay, 8, n_in=64)
                  if c[0] is fk.attention_sel_fwd]
    _, u1, u2, ud, c, a1, a2, _ = args
    cot = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    grads = {}
    for dt in (BF16, torch.float32):
        leaves = [u1.to(BF16).to(dt).requires_grad_(),
                  u2.to(BF16).to(dt).requires_grad_(),
                  ud.to(BF16).to(dt).requires_grad_(),
                  a1.clone().requires_grad_(), a2.clone().requires_grad_()]
        p1, p2, pd, q1, q2 = leaves
        out = fn.apply(lay, p1, p2, pd, c, q1, q2, SLOPE)
        assert out.dtype == dt
        (out.float() * cot).sum().backward()
        grads[dt] = [t.grad for t in leaves]
    for g16, g32, want in zip(grads[BF16], grads[torch.float32],
                              (BF16, BF16, BF16, torch.float32,
                               torch.float32)):
        assert g16.dtype == want and torch.isfinite(g16).all()
        scale = float(g32.abs().max())
        torch.testing.assert_close(g16.float(), g32, rtol=4 * BF16_ROUND,
                                   atol=4 * BF16_ROUND * scale)


def test_conv_output_is_f32_before_batch_norm(rng):
    """A bf16 conv runs its attention on bf16 tables and hands batch norm
    an f32 output; its parameters stay f32, and the model refuses a
    message dtype the kernels do not take."""
    g = with_self_loops(graph_from_dict(_graph(rng, n=100, e=500, d=8)))
    adj = adjacency_from_graph(g, method="blocked", node_block=128,
                               device="cpu")
    conv = AdaptedConv(8, 16, msg_dtype="bfloat16",
                       generator=torch.Generator().manual_seed(0))
    seen = []
    real = tk.attention_sel

    def spy(lay, u1, u2, *a):
        seen.append((u1.dtype, u2.dtype))
        return real(lay, u1, u2, *a)

    with mock.patch.object(tk, "attention_sel", spy):
        out = conv(g.x, adj, g.central_mask, g.node_mask)
    assert seen == [(BF16, BF16)]
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert all(p.dtype == torch.float32 for p in conv.parameters())
    with pytest.raises(ValueError, match="msg_dtype"):
        KTGNN(4, 8, hidden=16, msg_dtype="float16")


def test_flax_weights_load_into_a_bf16_model():
    """io/flax_weights needs nothing for bf16 messages: the JAX pickle's
    weights load strictly into a bf16 model, stay f32 and export back to
    the same pickle."""
    data = sync_data(dim=DIM, num_classes=CLASSES)
    _, variables = _jax_variables(data)
    model = build_model(Stage2Config(hidden=HIDDEN,
                                     message_dtype="bfloat16"), CLASSES,
                        DIM, device="cpu")
    model.load_state_dict(state_dict_from_flax(model, variables),
                          strict=True)
    sd = model.state_dict()
    assert all(t.dtype == torch.float32 for t in sd.values()
               if t.is_floating_point())
    back = flax_variables_from_state_dict(model, sd)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, variables))


# ------------------------------------------------------------- the trainer


def _cfg(**kw):
    return Stage2Config(**{**dict(num_epoch=6, hidden=8, lr=1e-2,
                                  step_size=3, log_every=0,
                                  message_dtype="bfloat16",
                                  matmul_precision="default"), **kw})


@pytest.mark.parametrize("method", ["blocked", "tiered"])
def test_bf16_training_runs_and_scan_equals_loop(method):
    """The production setting on the CPU: bf16 messages, precision
    "default", dropout 0.5. Every loss finite and falling, and scan mode
    (chunks of 4 and 2) gives the per-epoch loop's history, best dict and
    weights exactly."""
    data = (skewed_data(np.random.default_rng(5), n=160, c=3, d=12)
            if method == "tiered" else sync_data())
    data["test_mask"] = ~data["train_mask"]
    loop = train_ktgnn(data, _cfg(adjacency_method=method), device="cpu")
    scan = train_ktgnn(data, _cfg(adjacency_method=method, scan_epochs=4),
                       device="cpu")
    losses = [h["loss"] for h in loop["history"]]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert scan["history"] == loop["history"]
    assert scan["best"] == loop["best"]
    for k, t in loop["state_dict"].items():
        assert t.dtype == scan["state_dict"][k].dtype
        assert torch.equal(scan["state_dict"][k], t), k


def test_bf16_step_differs_from_f32_only_by_rounding():
    """One bf16 step and one f32 step from the same weights: the bf16
    messages do run (the losses differ), within bf16 rounding."""
    data = sync_data()
    f32 = train_ktgnn(data, _cfg(num_epoch=1, message_dtype=None,
                                 matmul_precision=None), device="cpu")
    b16 = train_ktgnn(data, _cfg(num_epoch=1), device="cpu")
    a, b = f32["history"][0]["loss"], b16["history"][0]["loss"]
    assert a != b and abs(a - b) <= 4 * BF16_ROUND * abs(a)


@pytest.mark.parametrize("field,value", [("message_dtype", "float16"),
                                         ("message_dtype", "float32"),
                                         ("matmul_precision", "tf32")])
def test_bad_names_raise(field, value):
    with pytest.raises(ValueError, match=field):
        train_ktgnn(sync_data(), _cfg(**{field: value}), device="cpu")


@pytest.mark.parametrize("name,tf32", [(None, False), ("highest", False),
                                       ("float32", False), ("default", True),
                                       ("bfloat16", True)])
def test_matmul_precision_sets_cuda_tf32_inside_the_run(name, tf32):
    """train_ktgnn sets the CUDA TF32 flag for its whole run (read here
    inside every train step) and restores the caller's value after, from
    either value; CPU matmuls are not touched."""
    cublas = torch.backends.cuda.matmul
    seen = []
    step = ts2.train_step

    def spy(*a, **k):
        seen.append(cublas.allow_tf32)
        return step(*a, **k)

    for before in (False, True):
        cublas.allow_tf32 = before
        try:
            with mock.patch.object(ts2, "train_step", spy):
                train_ktgnn(sync_data(), _cfg(num_epoch=2,
                                              matmul_precision=name),
                            device="cpu")
            assert cublas.allow_tf32 is before
        finally:
            cublas.allow_tf32 = False
    assert seen == [tf32] * 4
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with matmul_precision(name):
        inside = a @ b
    assert torch.equal(inside, a @ b)


def test_cli_runs_the_production_flags(tmp_path, capsys):
    """The training CLI with --message_dtype bfloat16 --matmul_precision
    default --scan_epochs 3 on the CPU."""
    npz = str(tmp_path / "g.npz")
    save_graph_npz(npz, sync_data())
    res = tcli2.main(tcli2.build_argparser().parse_args([
        "--path_data", npz, "--num_epoch", "6", "--hidden_dim", "8",
        "--to_undirected", "--log_every", "2", "--message_dtype",
        "bfloat16", "--matmul_precision", "default", "--scan_epochs", "3",
        "--ckpt_dir", str(tmp_path / "ck"), "--device", "cpu"]))
    out = capsys.readouterr().out
    assert "[stage-2 best]" in out and "Epoch 006 loss" in out
    assert len(res["history"]) == 6
    assert np.all(np.isfinite([h["loss"] for h in res["history"]]))


def test_serve_cli_takes_matmul_precision(tmp_path):
    """The serving CLI's --matmul_precision (the JAX serve CLI's choices)
    goes to the predictor, shows in /meta, and on the CPU leaves every
    answer as it was."""
    data = sync_data(dim=DIM, num_classes=CLASSES)
    _, variables = _jax_variables(data)
    npz, ckpt = str(tmp_path / "g.npz"), tmp_path / "best.pkl"
    save_graph_npz(npz, data)
    with open(ckpt, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, variables), f)
    argv = ["--mode", "predictor", "--ckpt", str(ckpt), "--path_data", npz,
            "--hidden_dim", str(HIDDEN), "--to_undirected", "--device",
            "cpu"]
    ap = tcli.build_argparser()
    plain = tcli._load_predictor(ap.parse_args(argv))
    prec = tcli._load_predictor(ap.parse_args(
        argv + ["--matmul_precision", "default"]))
    assert prec.predictor.matmul_precision == "default"
    assert json.loads(json.dumps(prec.meta))["matmul_precision"] == "default"
    want, got = plain.predictor.predict(), prec.predictor.predict()
    for head in want:
        np.testing.assert_array_equal(got[head], want[head])
    with pytest.raises(SystemExit):
        ap.parse_args(argv + ["--matmul_precision", "tf32"])
    with pytest.raises(ValueError, match="matmul_precision"):
        KTGNNPredictor(build_model(Stage2Config(hidden=HIDDEN), CLASSES, DIM,
                                   device="cpu"), None, data, device="cpu",
                       matmul_precision="tf32")
