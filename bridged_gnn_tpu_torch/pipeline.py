"""One call for the whole two-stage pipeline on one device.

Port of ``bridged_gnn_tpu/pipeline.py``. ``run_pipeline(cfg)`` prepares
the datasets, trains the stage-1 similarity learner, builds the bridged
graph from its best weights and trains KT-GNN (or the configured
stage-2 model) on that graph: the reference's two CLIs run
back to back, as ``run.sh`` does, from one ``PipelineConfig``.

    python -m bridged_gnn_tpu_torch.pipeline --recipe sync_unrelational
    python -m bridged_gnn_tpu_torch.pipeline --config cfg.json \
        [--data_root DIR] [--out_dir DIR] [--device cuda]

prints ``[stage-1 best]``, ``[stage-2 best]`` and ``[diagnostics]``.
``--elastic`` (``elastic=True``) wraps both training stages in
``train/elastic.py::run_elastic``: a transient failure runs the stage
again (on each rank by itself; see :func:`run_pipeline`). ``mesh``,
a process group (``parallel/mesh.py::make_group``),
reaches the bridge's top-ks, which split their columns over its ranks;
the call is then made on every rank of the group and returns the same
result on each.
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Any, Dict, Optional

import torch.distributed as dist

from bridged_gnn_tpu_torch.bridge.build import gen_bridged_graph
from bridged_gnn_tpu_torch.config import RECIPES, PipelineConfig
from bridged_gnn_tpu_torch.data.datasets import prepare_datasets
from bridged_gnn_tpu_torch.io.serialize import save_graph_npz
from bridged_gnn_tpu_torch.train.stage1 import (
    prepare_stage1_graphs,
    train_adversarial,
)
from bridged_gnn_tpu_torch.train.stage2 import train_ktgnn
from bridged_gnn_tpu_torch.utils.diagnostics import (
    eval_bridged_graph,
    eval_homophily,
)
from bridged_gnn_tpu_torch.utils.platform import resolve_device


def _rank0_object(obj, group):
    """``obj`` as rank 0 of ``group`` holds it, on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def run_pipeline(cfg: PipelineConfig, out_dir: Optional[str] = None,
                 mesh=None, elastic: bool = False,
                 device="cuda") -> Dict[str, Any]:
    """Stage 1, the bridge and stage 2 of ``cfg`` on ``device``. Returns
    both stages' best scores, the bridged graph, its homophily
    diagnostics and each part's seconds on the host clock; ``out_dir``
    gets the graph as ``<dataset>_bridged_graph.npz``.

    ``elastic``: each training stage runs under ``run_elastic``.
    ``mesh``: a process group; call this on every rank of it. A stage
    whose ``n_shards`` is the group's size trains sharded over it, one
    with ``n_shards=1`` on every rank; either way rank 0's stage-1
    weights and stage-2 best are every rank's, the bridge's top-ks split
    their columns over the ranks, and every rank returns the same
    result.

    With both, each rank retries on its own, as the JAX package's
    processes do: nothing agrees on a retry across the group. A stage
    that shards over the group survives only a failure that meets every
    rank at the same point before its next collective; one rank failing
    alone leaves its peers waiting in a collective while it starts the
    stage again, and the group falls out of step. A stage with
    ``n_shards=1`` retries on each rank independently."""
    dev = resolve_device(device)
    stage1_fn, stage2_fn = train_adversarial, train_ktgnn
    if elastic:
        from bridged_gnn_tpu_torch.train.elastic import run_elastic

        stage1_fn = partial(run_elastic, train_adversarial)
        stage2_fn = partial(run_elastic, train_ktgnn)
    src_d, tar_d, _, m_src, m_tar = prepare_datasets(cfg.dataset_name,
                                                     cfg.data_root)
    seconds = {}
    t0 = time.perf_counter()
    res1 = stage1_fn(src_d, tar_d, cfg.stage1, device=dev)
    if mesh is not None:
        best, state = _rank0_object((res1["best"], res1["state_dict"]),
                                    mesh)
        res1["model"].load_state_dict(state)
        res1.update(best=best, state_dict=state)
    seconds["stage1"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    G = prepare_stage1_graphs(src_d, tar_d, cfg.stage1.backbone, dev)
    b = cfg.bridge
    merged = gen_bridged_graph(
        res1["model"], G.g_src, G.adj_src, G.g_tar, G.adj_tar, m_src, m_tar,
        k_cross=b.k_cross, k_within=b.k_within, check_cross=b.check_cross,
        check_within=b.check_within,
        thres_conf_quantile=b.thres_conf_quantile,
        thres_feat_sim=b.thres_feat_sim, sim_mode=cfg.stage1.sim_mode,
        epsilon=b.epsilon, row_block=b.row_block,
        approx_recall=b.approx_recall,
        rerank_candidates=b.rerank_candidates, mesh=mesh)
    diagnostics = dict(homophily=eval_homophily(merged),
                       local_homophily_test=eval_bridged_graph(merged))
    if out_dir and (mesh is None or dist.get_rank(mesh) == 0):
        os.makedirs(out_dir, exist_ok=True)
        save_graph_npz(
            os.path.join(out_dir, f"{cfg.dataset_name}_bridged_graph.npz"),
            merged)
    seconds["bridge"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    res2 = stage2_fn(merged, cfg.stage2, device=dev)
    if mesh is not None:
        res2["best"] = _rank0_object(res2["best"], mesh)
    seconds["stage2"] = time.perf_counter() - t0
    return dict(stage1=res1["best"], stage2=res2["best"],
                bridged_graph=merged, diagnostics=diagnostics,
                seconds=seconds)


def main(argv=None) -> Dict[str, Any]:
    """``python -m bridged_gnn_tpu_torch.pipeline --recipe <name>`` (or
    ``--config cfg.json``): the whole pipeline from a recipe of
    ``config.RECIPES`` or a ``PipelineConfig`` JSON file."""
    import argparse
    import dataclasses

    ap = argparse.ArgumentParser(description=main.__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--recipe", choices=sorted(RECIPES))
    src.add_argument("--config", metavar="JSON",
                     help="path to a PipelineConfig JSON file")
    ap.add_argument("--data_root", default=None,
                    help="override the recipe's dataset root")
    ap.add_argument("--out_dir", default=None,
                    help="write the bridged graph npz here")
    ap.add_argument("--elastic", action="store_true", default=False)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    cfg = (RECIPES[args.recipe] if args.recipe
           else PipelineConfig.from_file(args.config))
    if args.data_root:
        cfg = dataclasses.replace(cfg, data_root=args.data_root)
    res = run_pipeline(cfg, out_dir=args.out_dir, elastic=args.elastic,
                       device=args.device)
    print("[stage-1 best]", res["stage1"])
    print("[stage-2 best]", {k: v for k, v in res["stage2"].items()
                             if k != "per_head"})
    print("[diagnostics]", res["diagnostics"])
    return res


if __name__ == "__main__":
    main()
