"""Stage-1 CLI: train the similarity learner and build the bridged graph.

Port of ``bridged_gnn_tpu/cli/main_bridged_graph.py``: the same flag
surface (reference main_bridged_graph.py:360-391) plus ``--device``
(default ``cuda``). ``--save`` writes the best weights as the JAX
package's flax-layout pickle (``<ckpt_dir>/model_AdvLearner_<dataset>_
best.pkl``, which either package loads) and the bridged graph as npz
(``<out_dir>/<dataset>_bridged_graph.npz``); ``--export_torch_ckpt``
writes the reference's ``state_dict`` layout.

``--topk_recall`` is accepted and selects exactly, as the JAX package
does on every backend but the TPU. ``--scan_epochs K`` trains in scan
mode (segments of up to K epochs, on the card one epoch captured in a
CUDA graph and replayed); ``--device_sampling`` draws the training pairs
on the device and evaluates with the device evaluator (it needs
``--scan_epochs``, as in the JAX package). ``--n_shards N`` trains
stage 1 with both domain graphs row-sharded over N ranks, which the
trainer starts itself outside ``torchrun`` (``train/stage1.py``); the
bridge is then built in this process from rank 0's best weights.

Example (``run.sh`` recipe 0, then stage 2 on its output):
  python -m bridged_gnn_tpu_torch.cli.main_bridged_graph \
      --dataset_name sync_unrelational --k_within 3 --k_cross 10 \
      --num_epoch 100 --start_eval_epoch 80 --eval_per_epoch 5 --seed 0 \
      --version v2 --save --out_dir out --ckpt_dir ck
  python -m bridged_gnn_tpu_torch.cli.main_graph_knowledge_transfer \
      --num_layer 2 --hidden_dim 64 --to_undirected \
      --path_data out/sync_unrelational_bridged_graph.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from bridged_gnn_tpu_torch.bridge.build import gen_bridged_graph
from bridged_gnn_tpu_torch.data.datasets import prepare_datasets
from bridged_gnn_tpu_torch.io.serialize import save_graph_npz
from bridged_gnn_tpu_torch.train.stage1 import (
    Stage1Config,
    check_ported,
    prepare_stage1_graphs,
    train_adversarial,
)
from bridged_gnn_tpu_torch.utils.diagnostics import (
    degree_stats,
    eval_bridged_graph,
    eval_homophily,
)
from bridged_gnn_tpu_torch.utils.platform import resolve_device
from bridged_gnn_tpu_torch.utils.profiling import trace
from bridged_gnn_tpu_torch.utils.seeding import set_random_seed


def _recall(v):
    f = float(v)
    if not 0.0 < f <= 1.0:
        raise argparse.ArgumentTypeError(
            f"--topk_recall must be in (0, 1], got {v} "
            "(did you pass a percentage?)")
    return f


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Training Scripts for Similarity Learner part of "
        "Bridged-GNN (PyTorch / CUDA)"
    )
    ap.add_argument("--dataset_name", type=str,
                    default="twitter_unrelational")
    ap.add_argument("--data_root", type=str, default="../datasets")
    ap.add_argument("--save", action="store_true", default=False)
    ap.add_argument("--check_within", action="store_true", default=False)
    ap.add_argument("--check_cross", action="store_true", default=False)
    ap.add_argument("--norm_mode", type=str, default="None")
    ap.add_argument("--version", type=str, default="v1",
                    choices=["v1", "v2"])
    ap.add_argument("--norm_scale", type=float, default=1.0)
    ap.add_argument("--num_epoch", type=int, default=400)
    ap.add_argument("--start_eval_epoch", type=int, default=300)
    ap.add_argument("--eval_per_epoch", type=int, default=1)
    ap.add_argument("--num_layer", type=int, default=2)
    ap.add_argument("--hidden_dim", type=int, default=64)
    ap.add_argument("--sim_mode", type=str, default="mlp",
                    choices=["cosine", "mlp"])
    ap.add_argument("--backbone", type=str, default="mlp",
                    choices=["gnn", "mlp"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epsilon", type=float, default=0.5)
    ap.add_argument("--thres_conf_quantile", type=float, default=0.1)
    ap.add_argument("--thres_feat_sim", type=float, default=0.8)
    ap.add_argument("--k_within", type=int, default=6)
    ap.add_argument("--k_cross", type=int, default=20)
    ap.add_argument("--batch_size", type=int, default=1000)
    # accepted and exact: the JAX package's approx_max_k selects exactly
    # off the TPU too
    ap.add_argument("--topk_recall", type=_recall, default=None)
    # mlp head: bf16 cosine screen, then the exact head at the top N
    # candidates of each row
    ap.add_argument("--mlp_rerank", type=int, default=None)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--max_class_num", type=int, default=10)
    ap.add_argument("--eval_mode", type=str, default="sampling",
                    choices=["all", "sampling"])
    ap.add_argument("--sample_size", type=int, default=40000)
    ap.add_argument("--ckpt_dir", type=str, default="../ckpt")
    ap.add_argument(
        "--export_torch_ckpt", type=str, default=None,
        help="also write the best model as a reference-layout torch "
             "state_dict pickle (loadable by the reference's "
             "gen_bridged_graph, main_bridged_graph.py:274)")
    ap.add_argument("--out_dir", type=str, default="../data_bridged_graph")
    ap.add_argument("--verbose", action="store_true", default=True)
    ap.add_argument("--scan_epochs", type=int, default=0)
    ap.add_argument("--device_sampling", action="store_true")
    ap.add_argument("--n_shards", type=int, default=1)
    # raise FloatingPointError on a non-finite loss or weight
    ap.add_argument("--check_numerics", action="store_true")
    # a torch.profiler Chrome trace of the training run, <dir>/trace.json
    ap.add_argument("--profile_dir", type=str, default=None)
    # where the run goes: the card (default) or the plain versions on the
    # CPU
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(args):
    cfg_flags = dict(scan_epochs=args.scan_epochs,
                     device_sampling=args.device_sampling,
                     n_shards=args.n_shards)
    # refuse an option that is not ported or device sampling without
    # scan mode, or a card that is absent, before any data is read
    check_ported(Stage1Config(**cfg_flags))
    resolve_device(args.device)
    set_random_seed(0)
    src_d, tar_d, _, m_src, m_tar = prepare_datasets(
        args.dataset_name, args.data_root)

    # twitter stage-1 quirk: the source graph is reduced to self loops
    # before training (reference main_bridged_graph.py:335-340)
    if args.dataset_name.split("_")[0] == "twitter":
        n = src_d["x"].shape[0]
        loops = np.arange(n, dtype=np.int64)
        src_d = dict(src_d, edge_index=np.stack([loops, loops]))

    # --version v1 is the GraphEncoder (SAGE) backbone with the cosine
    # head (reference Adversarial_Learner, models/models.py:815-844); v2
    # takes backbone and head from the flags (models.py:1110-1142)
    backbone = "gnn" if args.version == "v1" else args.backbone
    sim_mode = "cosine" if args.version == "v1" else args.sim_mode

    cfg = Stage1Config(
        hidden_dim=args.hidden_dim, num_layer=args.num_layer,
        num_epoch=args.num_epoch, start_eval_epoch=args.start_eval_epoch,
        eval_per_epoch=args.eval_per_epoch,
        max_class_num=args.max_class_num, sample_size=args.sample_size,
        sim_mode=sim_mode, backbone=backbone, norm_mode=args.norm_mode,
        norm_scale=args.norm_scale, eval_mode=args.eval_mode,
        seed=args.seed, repeat=args.repeat, verbose=args.verbose,
        check_numerics=args.check_numerics, **cfg_flags)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    ckpt_path = (os.path.join(
        args.ckpt_dir, f"model_AdvLearner_{args.dataset_name}_best.pkl")
        if args.save else None)
    if args.profile_dir:
        with trace(args.profile_dir, args.device):
            res = train_adversarial(src_d, tar_d, cfg, ckpt_path,
                                    device=args.device)
        print(f"profiler trace written to {args.profile_dir}")
    else:
        res = train_adversarial(src_d, tar_d, cfg, ckpt_path,
                                device=args.device)
    print("[stage-1 best]", res["best"])
    if args.export_torch_ckpt:
        from bridged_gnn_tpu_torch.io.ckpt_import import (
            reference_state_dict,
            save_torch_state_dict,
        )

        save_torch_state_dict(
            reference_state_dict(res["model"], res["state_dict"]),
            args.export_torch_ckpt)
        print("exported torch state_dict to", args.export_torch_ckpt)

    # bridge construction from the best weights
    G = prepare_stage1_graphs(src_d, tar_d, backbone, args.device)
    merged = gen_bridged_graph(
        res["model"], G.g_src, G.adj_src, G.g_tar, G.adj_tar, m_src, m_tar,
        k_cross=args.k_cross, k_within=args.k_within,
        check_cross=args.check_cross, check_within=args.check_within,
        thres_conf_quantile=args.thres_conf_quantile,
        thres_feat_sim=args.thres_feat_sim,
        sim_mode=sim_mode, epsilon=args.epsilon,
        # the reference's --batch_size is its scoring chunk
        # (main_bridged_graph.py:45,90); here the top-k's row block
        row_block=args.batch_size,
        verbose=args.verbose,
        approx_recall=args.topk_recall,
        rerank_candidates=args.mlp_rerank,
    )
    h1, h2 = eval_homophily(merged)
    local = eval_bridged_graph(merged)
    deg = degree_stats(merged["edge_index"], merged["x"].shape[0])
    print(f"homophily ratio: {h1:.4f} | 2nd-order: {h2:.4f} | "
          f"local>0.5 on test: {local:.4f} | degrees: {deg}")
    if args.save:
        os.makedirs(args.out_dir, exist_ok=True)
        out_path = os.path.join(
            args.out_dir, f"{args.dataset_name}_bridged_graph.npz")
        save_graph_npz(out_path, merged)
        print("saved bridged graph to", out_path)
    return merged


def cli_entry():
    main(build_argparser().parse_args())


if __name__ == "__main__":
    cli_entry()
