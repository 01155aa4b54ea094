"""PyTorch port, stage 1's model and trainer against the JAX package on
the same inputs: ``pair_norm`` in its four modes with padded rows; the
stage-1 family's forwards (v1: SAGE encoder and cosine head; v2: MLP
backbone and mlp head; the two mixed), ``SimNet`` and ``SimilarNoTrans``,
with weights carried across by ``io/flax_weights.py``; the flax and
reference checkpoint layouts; one similarity step and one discriminator
step against ``jax.value_and_grad`` through the JAX losses and their
``optax`` groups; ``train_adversarial`` for 4 epochs; the evaluator's one
encode per call; resume, repeats and the finite-state guard; scan mode
and device sampling running, and the option the port refuses.

The JAX package's dropout rates are constants (0.5 in the encoders, 0.6
in the classifier). Both sides run at dropout 0 here, the JAX side
through a flax ``Dropout`` stand-in that returns its input, the port
through its rate attributes, so that the same function is compared.
"""

import pickle
from typing import Optional

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridged_gnn_tpu.graph import graph_from_dict as j_graph_from_dict
from bridged_gnn_tpu.io.ckpt_import import (
    flax_variables_to_torch_state_dict as j_to_torch_sd,
)
from bridged_gnn_tpu.nn import common as jcommon
from bridged_gnn_tpu.nn import stage1 as jst1
from bridged_gnn_tpu.ops.spmm import adjacency_from_graph as j_adj
from bridged_gnn_tpu.train import stage1 as js1

from bridged_gnn_tpu_torch.data.datasets import dataset_conversion
from bridged_gnn_tpu_torch.data.synthetic import make_sync_dataset
from bridged_gnn_tpu_torch.io.ckpt_import import (
    load_reference_state_dict,
    reference_state_dict,
)
from bridged_gnn_tpu_torch.io.flax_weights import (
    flax_variables_from_state_dict,
    state_dict_from_flax,
)
from bridged_gnn_tpu_torch.nn import common as tcommon
from bridged_gnn_tpu_torch.nn import stage1 as tst1
from bridged_gnn_tpu_torch.nn.common import MaskedBatchNorm
from bridged_gnn_tpu_torch.train import stage1 as ts1

N_SRC, N_TAR, DIM, CLASSES, HIDDEN = 60, 45, 10, 3, 16
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-4
# (name, backbone, sim_mode): v1 and v2 as the CLI maps them, and the two
# mixed
VARIANTS = [("v1", "gnn", "cosine"), ("v2", "mlp", "mlp"),
            ("gnn_mlp", "gnn", "mlp"), ("mlp_cosine", "mlp", "cosine")]
VARIANT_IDS = [v[0] for v in VARIANTS]


class _NoDropout(fnn.Module):
    """flax ``Dropout`` at rate 0: returns its input."""

    rate: float = 0.0
    deterministic: Optional[bool] = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    monkeypatch.setattr(tst1.GraphEncoder, "dropout_p", 0.0)
    monkeypatch.setattr(tcommon.MLPBackbone, "dropout_p", 0.0)
    monkeypatch.setattr(tst1.SourceLearnerV2, "clf_dropout_p", 0.0)


def domains(variant="relational-intra", seed=0):
    data = make_sync_dataset(variant, n_src=N_SRC, n_tar=N_TAR, dim=DIM,
                             num_classes=CLASSES, avg_degree=4, seed=seed)
    src, tar, _, _ = dataset_conversion(data, seed=seed)
    return src, tar


def _cfg(backbone, sim_mode, **kw):
    return ts1.Stage1Config(**{**dict(
        hidden_dim=HIDDEN, backbone=backbone, sim_mode=sim_mode,
        max_class_num=CLASSES, sample_size=900, num_epoch=4,
        start_eval_epoch=2, eval_per_epoch=2, eval_sample_size=600), **kw})


def _jcfg(cfg):
    return js1.Stage1Config(**{
        f: getattr(cfg, f) for f in (
            "hidden_dim", "num_layer", "num_epoch", "start_eval_epoch",
            "eval_per_epoch", "max_class_num", "sample_size", "sim_mode",
            "backbone", "norm_mode", "norm_scale", "use_clf", "use_norm",
            "eval_mode", "eval_sample_size", "seed", "metric",
            "conf_lower_bound")})


def jax_graphs(src, tar, backbone):
    gs, gt = j_graph_from_dict(src), j_graph_from_dict(tar)
    gnn = backbone == "gnn"
    return (gs, j_adj(gs, method="auto") if gnn else None,
            gt, j_adj(gt, method="auto") if gnn else None)


def jax_init(cfg, src, tar, seed=0):
    """The JAX model and its variables as ``js1.train_adversarial`` inits
    them for ``seed``."""
    model = js1.build_model(_jcfg(cfg), src, tar)
    gs, adj_s, gt, adj_t = jax_graphs(src, tar, cfg.backbone)
    key = jax.random.PRNGKey(seed)
    _, init_key, drop_key = jax.random.split(key, 3)
    variables = model.init(
        {"params": init_key, "dropout": drop_key}, gs.x, adj_s, gt.x, adj_t,
        jnp.zeros(4, jnp.int32), jnp.zeros(4, jnp.int32),
        mask_src=gs.node_mask, mask_tar=gt.node_mask,
        method=jst1.AdversarialLearnerV2.init_all)
    return model, jax.tree.map(np.asarray, variables)


def _perturb_stats(variables, seed=1):
    """The JAX variables with batch norms that are not the identity."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, variables)

    def walk(p, s):
        for k in s:
            if isinstance(s[k], dict) and "mean" in s[k]:
                n = s[k]["mean"].shape
                s[k]["mean"] = rng.normal(0, 0.3, n).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                p[k]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                p[k]["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
            elif isinstance(s[k], dict):
                walk(p[k], s[k])

    walk(out["params"], out["batch_stats"])
    return out


def port_model(cfg, src, tar, variables):
    model = ts1.build_model(cfg, src, tar, "cpu")
    model.load_state_dict(state_dict_from_flax(model, variables))
    return model


def _t(a, dtype=None):
    return torch.from_numpy(np.asarray(a, dtype=dtype))


def _close(got, want, tol=FWD_TOL, what=""):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), err_msg=what, **tol)


def _pairs(rng, n1, n2, m=40):
    return (rng.integers(0, n1, m).astype(np.int32),
            rng.integers(0, n2, m).astype(np.int32))


# ------------------------------------------------------------- pair_norm


@pytest.mark.parametrize("mode", ["None", "PN", "PN-SI", "PN-SCS"])
def test_pair_norm_matches_jax_over_masked_rows(mode):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(24, 6)).astype(np.float32)
    mask = np.arange(24) < 19
    want = np.asarray(jcommon.pair_norm(jnp.asarray(x), jnp.asarray(mask),
                                        mode=mode, scale=1.5))
    got = tcommon.pair_norm(_t(x), _t(mask), mode=mode, scale=1.5)
    _close(got, want)
    # padded rows move no statistic: other values there, same real rows
    x2 = x.copy()
    x2[19:] = 1e3
    again = tcommon.pair_norm(_t(x2), _t(mask), mode=mode, scale=1.5)
    _close(again[:19], want[:19])


# --------------------------------------------------------------- modules


@pytest.mark.parametrize("name,backbone,sim_mode", VARIANTS,
                         ids=VARIANT_IDS)
def test_stage1_forward_matches_jax(no_dropout, name, backbone, sim_mode):
    """Eval-mode inference calls, and the train-mode ``train_forward``
    with the batch statistics it leaves, against the JAX model's."""
    src, tar = domains()
    cfg = _cfg(backbone, sim_mode)
    jmodel, variables = jax_init(cfg, src, tar)
    variables = _perturb_stats(variables)
    model = port_model(cfg, src, tar, variables)
    G = ts1.prepare_stage1_graphs(src, tar, backbone, "cpu")
    gs, adj_s, gt, adj_t = jax_graphs(src, tar, backbone)
    rng = np.random.default_rng(2)
    i1, i2 = _pairs(rng, N_SRC, N_TAR)

    want = jmodel.apply(variables, gs.x, adj_s, gt.x, adj_t, i1, i2,
                        mask_src=gs.node_mask, mask_tar=gt.node_mask,
                        method=jst1.AdversarialLearnerV2.get_probs_cross_domain)
    model.eval()
    with torch.no_grad():
        got = model.get_probs_cross_domain(
            G.g_src.x, G.adj_src, G.g_tar.x, G.adj_tar, _t(i1).long(),
            _t(i2).long(), G.g_src.node_mask, G.g_tar.node_mask)
        for g, w, what in zip(got, want, ("pair", "clf_src", "clf_tar",
                                          "z_src", "z_tar")):
            _close(g, w, what=what)
        for domain, g, j_g, j_a in (("source", G.g_src, gs, adj_s),
                                    ("target", G.g_tar, gt, adj_t)):
            adj = G.adj_src if domain == "source" else G.adj_tar
            w = jmodel.apply(
                variables, j_g.x, j_a, i1 % 40, i2 % 40, domain=domain,
                mask=j_g.node_mask,
                method=jst1.AdversarialLearnerV2.get_probs_within_domain)
            g_out = model.get_probs_within_domain(
                g.x, adj, _t(i1 % 40).long(), _t(i2 % 40).long(), domain,
                g.node_mask)
            for a, b in zip(g_out, w):
                _close(a, b, what=domain)

    # train mode: BN batch statistics, the running ones updated
    j3 = [_pairs(rng, n1, n2) for n1, n2 in
          ((N_SRC, N_SRC), (N_TAR, N_TAR), (N_SRC, N_TAR))]
    out_j, mut = jmodel.apply(
        variables, gs.x, adj_s, gt.x, adj_t, *[a for p in j3 for a in p],
        mask_src=gs.node_mask, mask_tar=gt.node_mask, train=True,
        rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"],
        method=jst1.AdversarialLearnerV2.train_forward)
    model.train()
    out_t = model.train_forward(
        G.g_src.x, G.adj_src, G.g_tar.x, G.adj_tar,
        *[_t(a).long() for p in j3 for a in p],
        mask_src=G.g_src.node_mask, mask_tar=G.g_tar.node_mask)
    for k, w in out_j.items():
        _close(out_t[k], w, what=k)
    want_sd = state_dict_from_flax(model, dict(
        params=variables["params"],
        batch_stats=jax.tree.map(np.asarray, mut["batch_stats"])))
    for k, v in model.state_dict().items():
        if "running" in k:
            _close(v, want_sd[k], what=k)


@pytest.mark.parametrize("use_bn", [False, True])
def test_simnet_and_similar_no_trans_match_jax(use_bn):
    rng = np.random.default_rng(3)
    z = rng.normal(size=(30, 8)).astype(np.float32)
    i1, i2 = _pairs(rng, 30, 30, 25)
    jnet = jst1.SimNet(dim_hidden=12, num_layer=3, use_bn=use_bn,
                       act_fn="leakyrelu")
    variables = jax.tree.map(np.asarray, jnet.init(
        jax.random.PRNGKey(0), z, i1, i2))
    if use_bn:
        variables = _perturb_stats(variables)
    net = tst1.SimNet(8, 12, num_layer=3, use_bn=use_bn, act_fn="leakyrelu")
    net.load_state_dict(state_dict_from_flax(net, variables))
    for train in (False, True):
        out = jnet.apply(variables, z, i1, i2, train=train,
                         mutable=["batch_stats"] if train else False)
        want = out[0] if train else out
        net.train(train)
        _close(net(_t(z), _t(i1).long(), _t(i2).long()), want,
               what=f"SimNet train={train}")

    jhead = jst1.SimilarNoTrans(in_channels=8, num_clf_classes=3,
                                dropout=0.0)
    hv = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(1), z, i1,
                                             i2))
    head = tst1.SimilarNoTrans(8, 3, dropout=0.0)
    head.load_state_dict(state_dict_from_flax(head, hv))
    probs, logp = jhead.apply(hv, z, i1, i2)
    got = head(_t(z), _t(i1).long(), _t(i2).long())
    _close(got[0], probs)
    _close(got[1], logp)
    _close(head.similarity_cross_domain(_t(z), _t(z[::-1].copy()),
                                        _t(i1).long(), _t(i2).long()),
           jhead.apply(hv, z, z[::-1], i1, i2,
                       method=jst1.SimilarNoTrans.similarity_cross_domain))


# --------------------------------------------------------------- weights


@pytest.mark.parametrize("name,backbone,sim_mode", VARIANTS[:2],
                         ids=VARIANT_IDS[:2])
def test_stage1_weights_round_trip_and_load_in_jax(tmp_path, name, backbone,
                                                   sim_mode):
    """flax → state dict → flax is bit-exact both ways; a checkpoint the
    port writes (its own init, BN statistics drawn) loads into the JAX
    model and gives the same probabilities; the reference-layout export
    equals JAX's on the same weights and loads back."""
    src, tar = domains()
    cfg = _cfg(backbone, sim_mode)
    jmodel, variables = jax_init(cfg, src, tar)
    model = ts1.build_model(cfg, src, tar, "cpu", seed=5)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, MaskedBatchNorm):
                bn.running_mean.normal_(0.0, 0.3, generator=gen)
                bn.running_var.uniform_(0.5, 1.5, generator=gen)
    sd = model.state_dict()
    back = flax_variables_from_state_dict(model, sd)
    for k, v in state_dict_from_flax(model, back).items():
        assert torch.equal(v, sd[k]), k
    again = flax_variables_from_state_dict(
        model, state_dict_from_flax(model, variables))
    jax.tree.map(np.testing.assert_array_equal, again, variables)

    path = tmp_path / "ck.pkl"
    with open(path, "wb") as f:
        pickle.dump(back, f)
    with open(path, "rb") as f:
        loaded = pickle.load(f)
    gs, adj_s, gt, adj_t = jax_graphs(src, tar, backbone)
    G = ts1.prepare_stage1_graphs(src, tar, backbone, "cpu")
    i1, i2 = _pairs(np.random.default_rng(4), N_SRC, N_TAR)
    want = jmodel.apply(loaded, gs.x, adj_s, gt.x, adj_t, i1, i2,
                        mask_src=gs.node_mask, mask_tar=gt.node_mask,
                        method=jst1.AdversarialLearnerV2.get_probs_cross_domain)
    model.eval()
    with torch.no_grad():
        got = model.get_probs_cross_domain(
            G.g_src.x, G.adj_src, G.g_tar.x, G.adj_tar, _t(i1).long(),
            _t(i2).long(), G.g_src.node_mask, G.g_tar.node_mask)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)

    ref = reference_state_dict(model)
    j_ref = j_to_torch_sd(back)
    assert sorted(ref) == sorted(j_ref)
    for k in ref:
        np.testing.assert_array_equal(ref[k], np.asarray(j_ref[k]), k)
    loaded_sd = load_reference_state_dict(model, ref)
    for k, v in loaded_sd.items():
        assert torch.equal(v, sd[k]), k


# ------------------------------------------------------------ train step


def _epoch_pairs(src, tar, cfg, seed=0):
    rng = np.random.default_rng(seed)
    enus = (js1.PairEnumerator(src, "train", rng),
            js1.PairEnumerator(tar, "train", rng),
            js1.PairEnumeratorCross(src, tar, "train", rng))
    out = [e.sampling(cfg.max_class_num, cfg.sample_size) for e in enus]
    ys, yt = src["y"], tar["y"]
    idxs = dict(src1=out[0][0], src2=out[0][1], tar1=out[1][0],
                tar2=out[1][1], cross1=out[2][0], cross2=out[2][1])
    y_pairs = dict(
        src=(ys[out[0][0]] == ys[out[0][1]]).astype(np.float32),
        tar=(yt[out[1][0]] == yt[out[1][1]]).astype(np.float32),
        cross=(ys[out[2][0]] == yt[out[2][1]]).astype(np.float32))
    return idxs, y_pairs


# Adam's first step moves an element by lr · g / (|g| + eps), g its
# gradient plus the L2 term (1e-8 = eps). Where g lies within rounding of
# 0 that step is set by g's last bits, of any sign, at most lr: a batch
# norm (lin_self_2) follows the similarity head's first biases through
# linear maps only and removes them, and among thousands of elements a few
# have a loss gradient that the L2 term cancels. Such an element may part
# from JAX's, and only such a one: its gradient within ADAM_NOISE of 0.
ADAM_NOISE = 1e-6
# each group's (lr, weight decay), make_optimizers
GROUPS = {"source_learner": (1e-2, 5e-3), "target_learner": (1e-3, 0.0),
          "discriminator": (1e-3, 0.0)}


@pytest.mark.parametrize("name,backbone,sim_mode", VARIANTS[:2],
                         ids=VARIANT_IDS[:2])
def test_one_training_step_matches_jax(no_dropout, name, backbone,
                                       sim_mode):
    """One similarity step and one discriminator step from the same
    variables and pairs: the updated parameters and batch statistics
    against ``make_train_steps``' (``jax.value_and_grad`` through JAX's
    ``sim_loss``/``d_loss``, its two optax groups); the discriminator
    untouched by the similarity step."""
    src, tar = domains()
    cfg = _cfg(backbone, sim_mode)
    jmodel, variables = jax_init(cfg, src, tar)
    gs, adj_s, gt, adj_t = jax_graphs(src, tar, backbone)
    sim_step, d_step, tx_st, tx_d, _ = js1.make_train_steps(
        jmodel, gs, adj_s, gt, adj_t, cfg.use_clf)
    idxs, y_pairs = _epoch_pairs(src, tar, cfg)
    params, bs = variables["params"], variables["batch_stats"]
    params, bs, _, loss_j, aux_j = sim_step(
        params, bs, tx_st.init(params), jax.random.PRNGKey(0),
        {k: jnp.asarray(v, jnp.int32) for k, v in idxs.items()},
        {k: jnp.asarray(v) for k, v in y_pairs.items()})
    params, _, dloss_j = d_step(params, bs, tx_d.init(params),
                                aux_j["h_src"], aux_j["h_tar"])
    want = state_dict_from_flax(
        port_model(cfg, src, tar, variables),
        jax.tree.map(np.asarray, dict(params=params, batch_stats=bs)))

    model = port_model(cfg, src, tar, variables)
    G = ts1.prepare_stage1_graphs(src, tar, backbone, "cpu")
    opts = ts1.make_optimizers(model)
    disc0 = {k: v.clone() for k, v in
             model.discriminator.state_dict().items()}
    loss, aux = ts1.sim_step(
        model, opts, G, {k: _t(v).long() for k, v in idxs.items()},
        {k: _t(v) for k, v in y_pairs.items()}, cfg.use_clf, None)
    for k, v in model.discriminator.state_dict().items():
        assert torch.equal(v, disc0[k]), k
    dloss = ts1.d_step(model, opts, G, aux["h_src"], aux["h_tar"])
    assert abs(float(loss) - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    assert abs(float(dloss) - float(dloss_j)) <= LOSS_RTOL * abs(
        float(dloss_j))
    params = dict(model.named_parameters())
    start = state_dict_from_flax(model, variables)
    noise, bad = 0, []
    for k, v in model.state_dict().items():
        far = ~torch.isclose(v, want[k], **STEP_TOL)
        if not far.any():
            continue
        lr, wd = GROUPS[k.split(".")[0]]
        g = (params[k].grad + wd * start[k])[far] if k in params else None
        moved = torch.stack([(v - start[k])[far],
                             (want[k] - start[k])[far]]).abs()
        if g is None or g.abs().max() >= ADAM_NOISE or moved.max() > lr:
            bad.append((k, float((v - want[k]).abs().max())))
        noise += int(far.sum())
    assert not bad, bad
    assert noise <= 0.01 * sum(p.numel() for p in params.values()), noise


# ------------------------------------------------------- train_adversarial


def _record_jax_losses(monkeypatch):
    """Per-epoch (sim, d, ae) losses of ``js1.train_adversarial``."""
    seen = []
    real = js1.make_train_steps

    def recording(*args, **kwargs):
        sim_step, d_step, *rest = real(*args, **kwargs)

        def sim(*a):
            out = sim_step(*a)
            seen.append([float(out[3]), None, float(out[4]["loss_ae"])])
            return out

        def d(*a):
            out = d_step(*a)
            seen[-1][1] = float(out[2])
            return out

        return (sim, d, *rest)

    monkeypatch.setattr(js1, "make_train_steps", recording)
    return seen


# v1 and v2, and v1 scoring every pair with the confidence filter
ADVERSARIAL = [v + ({},) for v in VARIANTS[:2]] + [
    ("v1_all_conf", "gnn", "cosine",
     dict(eval_mode="all", conf_lower_bound=0.3))]


@pytest.mark.parametrize("name,backbone,sim_mode,extra", ADVERSARIAL,
                         ids=[a[0] for a in ADVERSARIAL])
def test_train_adversarial_matches_jax(no_dropout, monkeypatch, name,
                                       backbone, sim_mode, extra):
    """4 epochs, evaluating at 2 and 4, from the same initial weights and
    pair stream: every epoch's losses within rtol 1e-4 of JAX's
    ``train_adversarial``; every evaluation equal to the JAX evaluator's
    on the port's weights of that epoch and the same pairs; the best
    dict the one those evaluations select.

    The two runs' own evaluations may part: the biases that ADAM_NOISE
    names take steps of rounding noise (their gradient is 0 in train
    mode, where lin_self_2's batch mean removes them), and in eval mode
    lin_self_2's running mean lags them, so the two runs' eval scores
    differ in a few pairs near 0.5."""
    src, tar = domains()
    cfg = _cfg(backbone, sim_mode, **extra)
    jmodel, variables = jax_init(cfg, src, tar)
    seen = _record_jax_losses(monkeypatch)
    js1.train_adversarial(src, tar, _jcfg(cfg))

    real_build = ts1.build_model

    def jax_weights(c, s, t, *_):
        model = real_build(c, s, t, "cpu")
        model.load_state_dict(state_dict_from_flax(model, variables))
        return model

    gs, adj_s, gt, adj_t = jax_graphs(src, tar, backbone)
    jev = js1.Stage1Evaluator(jmodel, None, gs, adj_s, gt, adj_t, src, tar,
                              _jcfg(cfg), np.random.default_rng(0))
    evals = []
    real_eval = ts1.Stage1Evaluator.__call__

    def replayed(self, split, epoch=0):
        rng = np.random.default_rng()
        rng.bit_generator.state = self.enus[split][0].rng.bit_generator.state
        got = real_eval(self, split, epoch)
        for enus in jev.enus.values():
            for e in enus:
                e.rng = rng
        want = jev(flax_variables_from_state_dict(
            self.model, self.model.state_dict()), split, epoch)
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   err_msg=f"{split} at epoch {epoch}")
        evals.append((epoch, split, got))
        return got

    monkeypatch.setattr(ts1, "build_model", jax_weights)
    monkeypatch.setattr(ts1.Stage1Evaluator, "__call__", replayed)
    got = ts1.train_adversarial(src, tar, cfg, device="cpu")
    assert len(got["history"]) == len(seen) == cfg.num_epoch
    for h, (loss, loss_d, loss_ae) in zip(got["history"], seen):
        for a, b in ((h["loss"], loss), (h["loss_d"], loss_d),
                     (h["loss_ae"], loss_ae)):
            assert abs(a - b) <= LOSS_RTOL * abs(b), (h, loss, loss_d,
                                                       loss_ae)
    assert [(e, s) for e, s, _ in evals] == [
        (2, "val"), (2, "test"), (4, "val"), (4, "test")]
    vals = {e: v for e, s, v in evals if s == "val"}
    epoch = max(vals, key=lambda e: (vals[e][4], -e))
    assert got["best"]["epoch"] == epoch
    assert got["best"]["val"] == (vals[epoch][0], vals[epoch][2],
                                  vals[epoch][4])
    assert len(got["eval_s"]) == 2


def test_evaluator_encodes_once_as_per_chunk(no_dropout):
    """The evaluator's scores from one encode per call equal those of the
    whole model called per chunk (JAX's order), bit for bit."""
    src, tar = domains()
    cfg = _cfg("gnn", "cosine")
    _, variables = jax_init(cfg, src, tar)
    model = port_model(cfg, src, tar, _perturb_stats(variables))
    G = ts1.prepare_stage1_graphs(src, tar, "gnn", "cpu")
    ev = ts1.Stage1Evaluator(model, G, src, tar, cfg,
                             np.random.default_rng(0), chunk=97)
    z_src, z_tar = ev.encode()
    sim = model.source_learner.sim_net
    i1, i2 = _pairs(np.random.default_rng(5), N_SRC, N_TAR, 300)
    with torch.no_grad():
        once = ev._scores(
            lambda a, b: sim.similarity_cross_domain(z_src, z_tar, a, b),
            i1, i2)
        per_chunk = ts1._pair_scores_in_chunks(
            lambda a, b: model.get_probs_cross_domain(
                G.g_src.x, G.adj_src, G.g_tar.x, G.adj_tar, a, b,
                G.g_src.node_mask, G.g_tar.node_mask)[0][:, 0],
            i1, i2, "cpu", chunk=97)
        np.testing.assert_array_equal(once, per_chunk)
        s1, s2 = i1 % N_TAR, i2
        once = ev._scores(lambda a, b: sim.similarity(z_tar, a, b), s1, s2)
        per_chunk = ts1._pair_scores_in_chunks(
            lambda a, b: model.get_probs_within_domain(
                G.g_tar.x, G.adj_tar, a, b, "target",
                G.g_tar.node_mask)[0][:, 0], s1, s2, "cpu", chunk=97)
        np.testing.assert_array_equal(once, per_chunk)


# --------------------------------------------------------------- options


@pytest.mark.parametrize("field,value,item", [("n_shards", 2, "item 9")])
def test_stage1_n_shards_option_trains(field, value, item):
    """Row sharding (ROADMAP Queue 1 ``item``) trains: two gloo ranks
    the trainer starts itself, v1 for 4 epochs with its evaluations,
    finite losses (``tests/test_torch_stage1_sharded.py`` holds it
    against one device and JAX)."""
    src, tar = domains()
    cfg = _cfg("gnn", "cosine", **{field: value})
    res = ts1.train_adversarial(src, tar, cfg, device="cpu")
    assert [h["epoch"] for h in res["history"]] == [1, 2, 3, 4]
    assert np.all(np.isfinite([h["loss"] for h in res["history"]]))
    assert res["best"]["epoch"] in (2, 4) and len(res["eval_s"]) == 2


@pytest.mark.parametrize("options", [
    dict(scan_epochs=2), dict(scan_epochs=2, device_sampling=True)],
    ids=["scan_epochs", "device_sampling"])
def test_stage1_scan_options_run(options):
    """The JAX runtime's scan mode and device sampling run on the CPU:
    segments of 2 epochs ending on the evaluations at 2 and 4, every
    epoch's losses finite (``tests/test_torch_stage1_scan.py`` holds them
    against JAX and the loop)."""
    src, tar = domains()
    res = ts1.train_adversarial(src, tar, _cfg("gnn", "cosine", **options),
                                device="cpu")
    assert res["scan"]["segments"] == [(1, 2), (3, 4)]
    assert [h["epoch"] for h in res["history"]] == [1, 2, 3, 4]
    assert np.all(np.isfinite([h[k] for h in res["history"]
                               for k in ("loss", "loss_d", "loss_ae")]))
    assert len(res["eval_s"]) == 2 and res["best"]["epoch"] in (2, 4)


def test_stage1_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, tar = domains()
    with pytest.raises(RuntimeError, match="cuda"):
        ts1.train_adversarial(src, tar, _cfg("gnn", "cosine"))
    with pytest.raises(RuntimeError, match="cuda"):
        ts1.build_model(_cfg("gnn", "cosine"), src, tar)


# ------------------------------------------------- loop-mode options


def test_stage1_resume_repeats_the_run(tmp_path, monkeypatch):
    """A run checkpointed at epoch 2 and resumed to 4 continues a straight
    4-epoch run: epochs 3 and 4 draw the same pairs and dropout state
    (the host sampler's and the dropout generator's states come back)
    and give the same losses within rtol 1e-5 (a wrong Adam state would
    move epoch 4's by far more; not bit for bit: two identical CPU runs
    already part in the last bit of epoch 3's loss)."""
    src, tar = domains()
    seen = []
    real_step = ts1.sim_step

    def recording(model, opts, G, idxs, y_pairs, use_clf, gen):
        seen.append(({k: v.numpy().copy() for k, v in idxs.items()},
                     gen.get_state()))
        return real_step(model, opts, G, idxs, y_pairs, use_clf, gen)

    monkeypatch.setattr(ts1, "sim_step", recording)
    straight = ts1.train_adversarial(
        src, tar, _cfg("gnn", "cosine", start_eval_epoch=5), device="cpu")
    ck = str(tmp_path / "ck")
    ts1.train_adversarial(src, tar, _cfg("gnn", "cosine", num_epoch=2,
                                         start_eval_epoch=5, ckpt_dir=ck,
                                         ckpt_every=1), device="cpu")
    resumed = ts1.train_adversarial(
        src, tar, _cfg("gnn", "cosine", start_eval_epoch=5, ckpt_dir=ck,
                       resume=True), device="cpu")
    assert [h["epoch"] for h in resumed["history"]] == [3, 4]
    for (p_a, g_a), (p_b, g_b) in zip(seen[2:4], seen[6:8], strict=True):
        assert torch.equal(g_a, g_b)
        for k in p_a:
            np.testing.assert_array_equal(p_a[k], p_b[k])
    for a, b in zip(resumed["history"], straight["history"][2:]):
        for k in ("loss", "loss_d", "loss_ae"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (k, a, b)


def test_stage1_repeat_and_check_numerics(monkeypatch):
    """``repeat`` runs the seed once per repeat and summarises the
    repeats' best scores; ``check_numerics`` raises on a non-finite
    parameter."""
    src, tar = domains()
    res = ts1.train_adversarial(src, tar, _cfg("mlp", "cosine", repeat=2),
                                device="cpu")
    assert len(res["final"]["val"]) == 2
    assert res["final"]["val"][0] == res["final"]["val"][1]
    assert res["summary"]["val"]["std"] == [0.0, 0.0, 0.0]
    real_build = ts1.build_model

    def poisoned(*args):
        model = real_build(*args)
        with torch.no_grad():
            model.discriminator.layers[0].weight[0, 0] = float("nan")
        return model

    monkeypatch.setattr(ts1, "build_model", poisoned)
    with pytest.raises(FloatingPointError, match="epoch 1"):
        ts1.train_adversarial(src, tar, _cfg("mlp", "cosine",
                                             check_numerics=True),
                              device="cpu")
