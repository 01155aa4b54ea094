"""One call for the whole two-stage pipeline on one device.

Port of ``bridged_gnn_tpu/pipeline.py``. ``run_pipeline(cfg)`` prepares
the datasets, trains the stage-1 similarity learner, builds the bridged
graph from its best weights and trains KT-GNN (or the configured
stage-2 model) on that graph: the reference's two CLIs run
back to back, as ``run.sh`` does, from one ``PipelineConfig``.

    python -m bridged_gnn_tpu_torch.pipeline --recipe sync_unrelational
    python -m bridged_gnn_tpu_torch.pipeline --config cfg.json \
        [--data_root DIR] [--out_dir DIR] [--device cuda]

prints ``[stage-1 best]``, ``[stage-2 best]`` and ``[diagnostics]``. A
mesh and elastic retries wait for ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

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

_ITEM_9 = "see ROADMAP.md Queue 1 item 9 (multi-device)"


def run_pipeline(cfg: PipelineConfig, out_dir: Optional[str] = None,
                 mesh=None, elastic: bool = False,
                 device="cuda") -> Dict[str, Any]:
    """Stage 1, the bridge and stage 2 of ``cfg`` on ``device``. Returns
    both stages' best scores, the bridged graph, its homophily
    diagnostics and each part's seconds on the host clock; ``out_dir``
    gets the graph as ``<dataset>_bridged_graph.npz``."""
    if mesh is not None:
        raise NotImplementedError(f"run_pipeline(mesh=...) is not ported; "
                                  f"{_ITEM_9}")
    if elastic:
        raise NotImplementedError(f"run_pipeline(elastic=True) is not "
                                  f"ported; {_ITEM_9}")
    dev = resolve_device(device)
    src_d, tar_d, _, m_src, m_tar = prepare_datasets(cfg.dataset_name,
                                                     cfg.data_root)
    seconds = {}
    t0 = time.perf_counter()
    res1 = train_adversarial(src_d, tar_d, cfg.stage1, device=dev)
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
        rerank_candidates=b.rerank_candidates)
    diagnostics = dict(homophily=eval_homophily(merged),
                       local_homophily_test=eval_bridged_graph(merged))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        save_graph_npz(
            os.path.join(out_dir, f"{cfg.dataset_name}_bridged_graph.npz"),
            merged)
    seconds["bridge"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    res2 = train_ktgnn(merged, cfg.stage2, device=dev)
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
