"""PyTorch port, the configuration tree and the one-call pipeline
against the JAX package: every recipe equal to JAX's as a dict, a
``PipelineConfig`` JSON read by the other package as it was written,
``run_pipeline`` on a tiny synthetic config from JAX's stage-1 init at
dropout 0 giving JAX's bridged edge set but for named near-ties, the
pipeline CLI on a ``--config`` file, and ``--elastic``, which waited for
ROADMAP.md item 9.

Near-ties: the two runs' stage-1 weights part by Adam's rounding steps,
so their scores of the same pair differ by some s (measured on the
pairs both keep, held below STEP_SPREAD). A proposal whose score lies within
NEAR_TIE + 2·s of its row's k-th, or of a filter's quantile cut, or that
touches a node whose classifier argmax lies that close to a tie, may go
either way; every edge in one graph and not the other must be one of
those (``near_tie_edges``).
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest

from bridged_gnn_tpu import config as jconfig
from bridged_gnn_tpu import pipeline as jpipe
from bridged_gnn_tpu.bridge import build as jbuild

from bridged_gnn_tpu_torch import config as tconfig
from bridged_gnn_tpu_torch import pipeline as tpipe
from bridged_gnn_tpu_torch.bridge import build as tbuild
from bridged_gnn_tpu_torch.data.datasets import prepare_datasets
from bridged_gnn_tpu_torch.io.flax_weights import state_dict_from_flax
from bridged_gnn_tpu_torch.train import stage1 as ts1
from bridged_gnn_tpu_torch.train.stage1 import Stage1Config
from bridged_gnn_tpu_torch.train.stage2 import Stage2Config

from tests.test_torch_stage1 import jax_init, no_dropout  # noqa: F401

NEAR_TIE = 1e-5
# how far two stage-1 runs from the same init and pairs may score a pair
# apart after 3 epochs: their losses agree within 1e-5, but the biases
# that a batch norm removes in train mode (lin_self_0's) take Adam steps
# of ±lr set by rounding, which eval mode's running statistics do not
# remove (tests/test_torch_stage1.py, ADAM_NOISE); measured 3.2e-4 (v2)
# and 9.7e-4 (v1)
STEP_SPREAD = 5e-3


def _tiny(backbone="mlp", sim_mode="mlp", **stage1):
    """The JAX package's tiny sync pipeline
    (``tests/test_elastic_pipeline.py``), cut to 3 stage-1 epochs in one
    scan segment and 2 stage-2 epochs, with both bridge filters."""
    return tconfig.PipelineConfig(
        dataset_name="sync_relational-intra",
        stage1=Stage1Config(**{**dict(
            hidden_dim=16, num_epoch=3, start_eval_epoch=9,
            max_class_num=4, sample_size=1600, eval_sample_size=1600,
            scan_epochs=3, backbone=backbone, sim_mode=sim_mode), **stage1}),
        bridge=tconfig.BridgeConfig(k_cross=5, k_within=2, check_cross=True,
                                    check_within=True, row_block=512),
        stage2=Stage2Config(num_epoch=2, hidden=8, to_undirected=True))


# ------------------------------------------------------------- the config


@pytest.mark.parametrize("name", sorted(jconfig.RECIPES))
def test_recipes_equal_jax(name):
    assert sorted(tconfig.RECIPES) == sorted(jconfig.RECIPES)
    assert dataclasses.asdict(tconfig.RECIPES[name]) == \
        dataclasses.asdict(jconfig.RECIPES[name])


@pytest.mark.parametrize("name", ["office_amazon2dslr_tpu",
                                  "fb_hamilton2caltech"])
def test_config_json_round_trips_across_packages(name):
    """The port reads the JAX package's JSON and writes what JAX reads
    back, field for field; each package's own round trip is the
    identity."""
    jcfg = jconfig.RECIPES[name]
    tcfg = tconfig.PipelineConfig.from_json(jcfg.to_json())
    assert tcfg == tconfig.RECIPES[name]
    assert jconfig.PipelineConfig.from_json(tcfg.to_json()) == jcfg
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
    assert tconfig.PipelineConfig.from_json(tcfg.to_json()) == tcfg


def test_production_recipe_runs_the_ported_settings():
    """The production recipe's stage-1 settings, scan mode with device
    sampling, and its stage-2 ones pass the port's checks."""
    cfg = tconfig.RECIPES["office_amazon2dslr_tpu"]
    ts1.check_ported(cfg.stage1)
    assert cfg.stage1.scan_epochs == 25 and cfg.stage1.device_sampling
    assert ts1.use_device_evaluator(cfg.stage1)
    from bridged_gnn_tpu_torch.train.stage2 import check_ported

    check_ported(cfg.stage2)


# ----------------------------------------------------------- the pipeline


def _recorder(module, names):
    """Wrap ``module``'s proposal functions to keep what they return, by
    kind: (sim-aligned edges [2, R·k], sims [R, k]) and the classifier's
    probabilities."""
    seen = {}
    real_cross, real_within = module.propose_cross_edges, \
        module.propose_within_edges

    def cross(*args, **kw):
        out = real_cross(*args, **kw)
        seen["cross"] = (out[0], np.asarray(out[1]))
        seen["probs"] = dict(source=np.asarray(out[2]),
                             target=np.asarray(out[3]))
        return out

    def within(*args, **kw):
        out = real_within(*args, **kw)
        domain = args[names.index("domain")] if len(args) > names.index(
            "domain") else kw["domain"]
        seen[f"within_{domain}"] = (out[0], np.asarray(out[1]))
        return out

    return seen, dict(propose_cross_edges=cross,
                      propose_within_edges=within)


def _inverse(mapper, n):
    inv = np.empty(n, dtype=np.int64)
    for orig, new in mapper.items():
        inv[new] = orig
    return inv


def _pairs_scored_by_both(got, want):
    """The largest score difference of the two builds on a top-k pair
    both kept, over every kind: what their weights' rounding moves a
    score by."""
    spread = 0.0
    for kind in ("cross", "within_source", "within_target"):
        (g_ei, g_s), (w_ei, w_s) = got[kind], want[kind]
        g_cols, w_cols = g_ei[0].reshape(g_s.shape), w_ei[0].reshape(w_s.shape)
        for r in range(g_s.shape[0]):
            common, gi, wi = np.intersect1d(g_cols[r], w_cols[r],
                                            return_indices=True)
            if len(common):
                spread = max(spread, float(np.abs(g_s[r, gi]
                                                  - w_s[r, wi]).max()))
    return spread


def near_tie_edges(got, want, inv):
    """The edges two builds may part on, in the merged graph's ids, with
    ``s`` the largest difference of their scores on a pair both kept and
    ``p`` of their classifiers' probabilities: a top-k pair one build
    keeps and the other does not must lie within NEAR_TIE + 2·s of its
    row's k-th score on the build that keeps it (two score lists that
    differ by at most s cut apart only there); a proposal within
    NEAR_TIE + 2·s of a filter's quantile cut; a proposal touching a node
    whose classifier argmax differs, which must lie within NEAR_TIE + 2·p
    of a tie. Returns (the edges, s, p)."""
    s = _pairs_scored_by_both(got, want)
    p = max(float(np.abs(got["probs"][d] - want["probs"][d]).max())
            for d in ("source", "target"))
    tie, named, moved = NEAR_TIE + 2 * s, set(), {}

    def merged(kind, pairs):
        a, b = (("source", "target") if kind == "cross"
                else (kind[7:], kind[7:]))
        return {(int(inv[a][u]), int(inv[b][v])) for u, v in pairs.T}

    for dom in ("source", "target"):
        a, b = got["probs"][dom], want["probs"][dom]
        nodes = np.flatnonzero(a.argmax(1) != b.argmax(1))
        top2 = np.sort(b[nodes], 1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] <= NEAR_TIE + 2 * p).all(), \
            (dom, nodes)
        moved[dom] = nodes
    for kind in ("cross", "within_source", "within_target"):
        a, b = (("source", "target") if kind == "cross"
                else (kind[7:], kind[7:]))
        for side, other in ((got, want), (want, got)):
            ei, sims = side[kind]
            k = sims.shape[1]
            cols = ei[0].reshape(sims.shape)
            ocols = other[kind][0][0].reshape(sims.shape)
            for r in np.flatnonzero((np.sort(cols, 1)
                                     != np.sort(ocols, 1)).any(1)):
                for j in np.flatnonzero(~np.isin(cols[r], ocols[r])):
                    gap = float(sims[r, j] - sims[r, k - 1])
                    assert abs(gap) <= tie, (kind, r, cols[r, j], gap, s)
                    named |= merged(kind, ei[:, [r * k + j]])
            flat = sims.reshape(-1)
            cut = np.quantile(flat, 0.1)
            named |= merged(kind, ei[:, np.abs(flat - cut) <= tie])
            touch = np.isin(ei[0], moved[a]) | np.isin(ei[1], moved[b])
            named |= merged(kind, ei[:, touch])
    return named, s, p


@pytest.mark.parametrize("backbone,sim_mode", [("mlp", "mlp"),
                                               ("gnn", "cosine")],
                         ids=["v2", "v1"])
def test_run_pipeline_gives_jaxs_bridged_graph(no_dropout, monkeypatch,
                                               tmp_path, backbone, sim_mode):
    """The tiny pipeline, stage 1 from JAX's init at dropout 0 on the same
    host pair stream: the same node arrays, and the same edges but for
    named near-ties (NEAR_TIE); the npz in ``out_dir``; stage 2 trained
    on it."""
    cfg = _tiny(backbone, sim_mode)
    src, tar, _, m_src, m_tar = prepare_datasets(cfg.dataset_name,
                                                 cfg.data_root)
    _, variables = jax_init(cfg.stage1, src, tar)
    real_build = ts1.build_model

    def build(c, s, t, *_):
        model = real_build(c, s, t, "cpu")
        model.load_state_dict(state_dict_from_flax(model, variables))
        return model

    monkeypatch.setattr(ts1, "build_model", build)
    t_seen, t_wrap = _recorder(tbuild, ["model", "g", "adj", "domain"])
    j_seen, j_wrap = _recorder(jbuild, ["model", "variables", "g", "adj",
                                        "domain"])
    for mod, wrap in ((tbuild, t_wrap), (jbuild, j_wrap)):
        for attr, fn in wrap.items():
            monkeypatch.setattr(mod, attr, fn)
    got = tpipe.run_pipeline(cfg, out_dir=str(tmp_path), device="cpu")
    want = jpipe.run_pipeline(
        jconfig.PipelineConfig.from_json(cfg.to_json()))

    g, w = got["bridged_graph"], want["bridged_graph"]
    assert sorted(g) == sorted(w)
    for key in w:
        if key != "edge_index":
            np.testing.assert_array_equal(g[key], w[key], key)
    inv = {"source": _inverse(m_src, len(m_src)),
           "target": _inverse(m_tar, len(m_tar))}
    apart = set(map(tuple, g["edge_index"].T.tolist())) ^ set(
        map(tuple, w["edge_index"].T.tolist()))
    named, spread, p_spread = near_tie_edges(t_seen, j_seen, inv)
    # the two stage-1 runs part only by Adam's rounding steps (STEP_SPREAD)
    assert spread <= STEP_SPREAD and p_spread <= STEP_SPREAD, (spread,
                                                                p_spread)
    unexplained = apart - named
    assert not unexplained, sorted(unexplained)[:10]
    assert len(apart) <= 0.01 * w["edge_index"].shape[1]
    assert os.path.isfile(tmp_path / "sync_relational-intra_bridged_graph.npz")
    assert set(got["seconds"]) == {"stage1", "bridge", "stage2"}
    assert np.isfinite(got["stage2"]["loss"])
    assert np.allclose(got["diagnostics"]["homophily"],
                       want["diagnostics"]["homophily"], atol=1e-3)


def test_pipeline_cli_on_a_config_file(tmp_path):
    """``python -m bridged_gnn_tpu_torch.pipeline --config cfg.json`` on
    the CPU, with device sampling in stage 1: the three result lines and
    the npz."""
    cfg = _tiny(device_sampling=True, start_eval_epoch=3)
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        res = tpipe.main(["--config", str(path), "--out_dir", str(tmp_path),
                          "--device", "cpu"])
    out = text.getvalue()
    for line in ("[stage-1 best]", "[stage-2 best]", "[diagnostics]"):
        assert line in out
    assert "stage1" in res and np.isfinite(res["stage2"]["loss"])
    assert (tmp_path / "sync_relational-intra_bridged_graph.npz").exists()


def test_pipeline_elastic_runs_and_defaults_to_the_card(monkeypatch,
                                                         tmp_path):
    """Elastic retries and the mesh run: ``--elastic`` on the pipeline
    CLI trains both stages under ``run_elastic``
    (``tests/test_torch_elastic.py`` holds a retried run and ``mesh=``
    over two ranks against the straight run); without a card the
    pipeline raises rather than run on the CPU."""
    cfg = _tiny()
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        res = tpipe.main(["--config", str(path), "--elastic", "--device",
                          "cpu"])
    for line in ("[stage-1 best]", "[stage-2 best]", "[diagnostics]"):
        assert line in text.getvalue()
    assert np.isfinite(res["stage2"]["loss"])
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.run_pipeline(cfg)
