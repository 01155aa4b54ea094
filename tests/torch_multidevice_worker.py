"""Rank-side work of the PyTorch port's multi-device tests: sharded scan
mode (``tests/test_torch_sharded_scan.py``), row-sharded stage 1
(``tests/test_torch_stage1_sharded.py``), the sharded bridge top-k
(``tests/test_torch_sharded_topk.py``) and the pipeline over a group
with the edge-span placement (``tests/test_torch_elastic.py``). Imports
the port alone (never JAX): each function runs on every rank of one gloo
group that ``parallel.multihost.spawn`` starts, and returns numpy arrays
and numbers."""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from bridged_gnn_tpu_torch.train import stage1 as ts1
from bridged_gnn_tpu_torch.train.stage2 import Stage2Config, train_ktgnn


def _one_thread():
    """The ranks' tensors are a few rows wide: one thread each, so that
    the two ranks do not contend with the other test processes for the
    host's cores."""
    torch.set_num_threads(1)


# ------------------------------------------------------- sharded scan mode


def _run(data, kw):
    res = train_ktgnn(data, Stage2Config(**kw), device="cpu")
    return dict(history=res["history"], best=res["best"], scan=res["scan"],
                state={k: v.numpy() for k, v in res["state_dict"].items()})


def scan_rank_work(data, cases, resume_kw, ck_full, ck_cut):
    """Every case's sharded loop run and scan run, then the resume case:
    straight, and cut at its first chunk's end and resumed."""
    _one_thread()
    out = {name: dict(loop=_run(data, dict(kw, scan_epochs=0)),
                      scan=_run(data, kw))
           for name, kw in cases.items()}
    full = _run(data, dict(resume_kw, ckpt_dir=ck_full))
    cut_at = resume_kw["scan_epochs"]
    _run(data, dict(resume_kw, ckpt_dir=ck_cut, num_epoch=cut_at))
    resumed = _run(data, dict(resume_kw, ckpt_dir=ck_cut, resume=True))
    out["resume"] = dict(full=full, resumed=resumed)
    # a group of this rank alone (every rank forms every group)
    own = [dist.new_group([r]) for r in range(dist.get_world_size())]
    res = train_ktgnn(data, Stage2Config(**dict(cases["halo"], n_shards=1)),
                      device="cpu", group=own[dist.get_rank()])
    out["one_rank"] = dict(history=res["history"], best=res["best"],
                           scan=res["scan"], parallel=res["parallel"])
    out["rank"] = dist.get_rank()
    return out


# ------------------------------------------------------ row-sharded stage 1


def _no_dropout():
    from bridged_gnn_tpu_torch.nn import common, stage1

    stage1.GraphEncoder.dropout_p = 0.0
    common.MLPBackbone.dropout_p = 0.0
    stage1.SourceLearnerV2.clf_dropout_p = 0.0


def one_sim_step(G, model, cfg, idxs, y_pairs):
    """One similarity step at rate 0 (the weights stay; the gradients
    stay on them): the loss, the learners' gradients, every buffer."""
    opts = ts1.make_optimizers(model)
    for opt in opts.values():
        for group in opt.param_groups:
            group["lr"] = 0.0
    gen = torch.Generator().manual_seed(3)
    loss, _ = ts1.sim_step(model, opts, G, idxs, y_pairs, cfg.use_clf, gen)
    return dict(
        loss=float(loss),
        grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()
               if not n.startswith("discriminator")},
        buffers={n: b.numpy().copy() for n, b in model.named_buffers()})


def stage1_rank_work(src, tar, step_cases, pairs, train_cases, weights,
                     jax_src, jax_tar, jax_cases):
    """Per step case, one sharded similarity step with dropout on (the
    shards draw the single device's masks); per train case, the sharded
    ``train_adversarial`` and, for the scan case, its loop; then, at
    dropout 0 from given weights, the runs held against the JAX
    package's ``n_shards=2``."""
    _one_thread()
    from bridged_gnn_tpu_torch.parallel.collectives import GradAllReduce

    out = dict(step={}, train={}, jax={}, rank=dist.get_rank())
    for name, kw in step_cases.items():
        cfg = ts1.Stage1Config(**kw)
        G = ts1.prepare_sharded_stage1_graphs(src, tar, cfg.backbone,
                                              dist.group.WORLD, "cpu")
        model = ts1.build_model(cfg, src, tar, "cpu")
        G = dataclasses.replace(G, grad_sync=GradAllReduce(
            list(model.source_learner.parameters())
            + list(model.target_learner.parameters()), dist.group.WORLD))
        idxs, y_pairs = pairs
        out["step"][name] = one_sim_step(
            G, model, cfg, {k: torch.from_numpy(v) for k, v in idxs.items()},
            {k: torch.from_numpy(v) for k, v in y_pairs.items()})
    for name, kw in train_cases.items():
        res = ts1.train_adversarial(src, tar, ts1.Stage1Config(**kw),
                                    device="cpu")
        out["train"][name] = dict(history=res["history"], best=res["best"],
                                  scan=res["scan"])
    _no_dropout()
    real_build = ts1.build_model
    for name, kw in jax_cases.items():
        state = {k: torch.from_numpy(v) for k, v in weights[name].items()}

        def build(cfg, s, t, device="cuda", seed=None, state=state):
            model = real_build(cfg, s, t, device, seed)
            model.load_state_dict(state)
            return model

        ts1.build_model = build
        try:
            res = ts1.train_adversarial(jax_src, jax_tar,
                                        ts1.Stage1Config(**kw), device="cpu")
        finally:
            ts1.build_model = real_build
        out["jax"][name] = dict(history=res["history"], best=res["best"])
    return out


# -------------------------------------------------- the sharded bridge top-k


def topk_rank_work(cases, bridge):
    """``sharded_pair_topk`` of every case, then ``gen_bridged_graph``
    with ``mesh=`` for the bridge case's model and graphs."""
    _one_thread()
    from bridged_gnn_tpu_torch.bridge.build import gen_bridged_graph
    from bridged_gnn_tpu_torch.parallel.topk import sharded_pair_topk

    out = dict(topk={}, bridge={}, rank=dist.get_rank())
    for name, (arrays, kw) in cases.items():
        t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for k, v in arrays.items()}
        vals, idxs = sharded_pair_topk(dist.group.WORLD, **t, **kw)
        out["topk"][name] = (vals.numpy(), idxs.numpy())
    src, tar, m_src, m_tar, builds = bridge
    for name, (cfg_kw, state, kw) in builds.items():
        cfg = ts1.Stage1Config(**cfg_kw)
        model = ts1.build_model(cfg, src, tar, "cpu")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        G = ts1.prepare_stage1_graphs(src, tar, cfg.backbone, "cpu")
        out["bridge"][name] = gen_bridged_graph(
            model, G.g_src, G.adj_src, G.g_tar, G.adj_tar, m_src, m_tar,
            mesh=dist.group.WORLD, **kw)
    return out


# ------------------------------------- the pipeline over a group, placements


def pipeline_rank_work(cfg_json, data, out_dir, oom):
    """``run_pipeline(mesh=group, elastic=True)`` on this rank, stage 2's
    first attempt failing with ``torch.OutOfMemoryError(oom)``; the
    edge-span placement (``gspmd_setup``) of ``data`` under a KT-GNN
    forward; the pod mesh; the collectives' profiler ranges."""
    _one_thread()
    from bridged_gnn_tpu_torch import pipeline
    from bridged_gnn_tpu_torch.config import PipelineConfig
    from bridged_gnn_tpu_torch.parallel.gspmd import gspmd_setup
    from bridged_gnn_tpu_torch.parallel.multihost import (
        flat_edge_mesh,
        make_pod_mesh,
    )
    from bridged_gnn_tpu_torch.train import elastic
    from bridged_gnn_tpu_torch.train.stage2 import (
        build_model,
        prepare_stage2_graph,
    )

    real, attempts = pipeline.train_ktgnn, []

    def first_attempt_fails(*args, **kwargs):
        attempts.append(len(attempts) + 1)
        if len(attempts) == 1:
            raise torch.OutOfMemoryError(oom)
        return real(*args, **kwargs)

    pipeline.train_ktgnn = first_attempt_fails
    elastic.run_elastic.__kwdefaults__["retry_delay_s"] = 0.0
    res = pipeline.run_pipeline(PipelineConfig.from_json(cfg_json),
                                out_dir=out_dir, mesh=dist.group.WORLD,
                                elastic=True, device="cpu")
    cfg = Stage2Config(hidden=16, num_layer=2)
    g, _ = prepare_stage2_graph(data, cfg, "cpu", build_adj=False)
    model = build_model(cfg, g.num_classes, g.num_features, "cpu").eval()
    gs, adj = gspmd_setup(dist.group.WORLD, g, "cpu")
    with torch.no_grad():
        out = model(gs, adj)[2][: g.num_nodes].numpy()
    pod = make_pod_mesh()
    return dict(spans=_collective_spans(),pipeline=dict(stage1=res["stage1"], stage2=res["stage2"],
                              bridged_graph=res["bridged_graph"],
                              attempts=len(attempts)),
                gspmd=out, edge_pad=gs.num_edges_padded,
                span=int(adj.senders.shape[0]),
                pod=(pod.ranks, pod.axis_names),
                flat=tuple(flat_edge_mesh(pod).ranks), rank=dist.get_rank())


def _collective_spans():
    """The ``collective:<kind>`` ranges a profiler records around a
    differentiable sum and a row all-gather, forward and backward."""
    from torch.profiler import ProfilerActivity, profile

    from bridged_gnn_tpu_torch.parallel.collectives import (
        all_gather_rows,
        sum_over,
    )

    x = torch.ones(2, 3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (sum_over(dist.group.WORLD, x)[0].sum()
         + all_gather_rows(x, dist.group.WORLD).sum()).backward()
    return sorted({e.key for e in prof.key_averages()
                   if e.key.startswith("collective:")})
