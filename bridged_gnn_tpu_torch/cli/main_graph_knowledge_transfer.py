"""Stage-2 CLI: knowledge-transfer GNN training on a bridged graph.

Port of ``bridged_gnn_tpu/cli/main_graph_knowledge_transfer.py``: the
same flag surface (reference main_graph_knowledge_transfer.py:423-439)
plus ``--device`` (default ``cuda``). ``--path_data`` takes the npz graph
format or the reference's ``.dat`` pickle (``io/pyg_compat.py``).
``--model_name`` picks KT-GNN or a zoo model; ``--no_dtc`` is the
reference's recipe, GraphSAGE without the scheduler, whatever
``--model_name`` says (JAX CLI :111-124).

``--n_shards N`` trains over N ranks (``--shard_layout``, ``--halo_overlap``;
``parallel/stage2_runtime.py``). Under ``torchrun --nproc_per_node N`` every
rank runs this CLI and joins the group from torchrun's environment;
otherwise the CLI starts the N local ranks itself. Rank 0 prints.

``--profile_dir`` writes a ``torch.profiler`` Chrome trace of the run.

Example:
  python -m bridged_gnn_tpu_torch.cli.main_graph_knowledge_transfer \
      --num_layer 2 --hidden_dim 64 --path_data g.npz --to_undirected \
      --scan_epochs 10
  python -m bridged_gnn_tpu_torch.cli.main_graph_knowledge_transfer \
      --path_data g.npz --to_undirected --n_shards 2 --halo_overlap
"""

from __future__ import annotations

import argparse
import os

from bridged_gnn_tpu_torch.io.pyg_compat import load_pyg_data_dict
from bridged_gnn_tpu_torch.io.serialize import load_graph_npz
from bridged_gnn_tpu_torch.parallel.multihost import is_primary
from bridged_gnn_tpu_torch.train.stage2 import Stage2Config, train_ktgnn
from bridged_gnn_tpu_torch.utils.diagnostics import eval_bridged_graph
from bridged_gnn_tpu_torch.utils.profiling import trace


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Knowledge transfer on a learned bridged-graph "
        "(PyTorch / CUDA)"
    )
    ap.add_argument("--dataset_name", type=str,
                    default="twitter_unrelational")
    ap.add_argument("--model_name", type=str, default="KTGNN",
                    choices=["MLP", "GCN", "GAT", "GATv2", "GraphSAGE", "GIN",
                             "JKNet", "APPNP", "GCN2", "DeeperGCN", "KTGNN"])
    ap.add_argument("--eval_metric", type=str, default="f1",
                    choices=["f1", "auc", "acc"])
    ap.add_argument("--save", action="store_true", default=False)
    ap.add_argument("--to_undirected", action="store_true", default=False)
    ap.add_argument("--no_dtc", action="store_true", default=False)
    ap.add_argument("--num_layer", type=int, default=2)
    ap.add_argument("--num_epoch", type=int, default=300)
    ap.add_argument("--hidden_dim", type=int, default=64)
    ap.add_argument("--path_data", type=str, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--ckpt_dir", type=str, default="../ckpt")
    ap.add_argument("--matmul_precision", type=str, default=None,
                    choices=["highest", "float32", "default", "bfloat16"])
    ap.add_argument("--message_dtype", type=str, default=None,
                    choices=["bfloat16"])
    ap.add_argument("--scan_epochs", type=int, default=0)
    ap.add_argument("--check_numerics", action="store_true")
    ap.add_argument("--memory_policy", type=str, default="auto",
                    choices=["auto", "plain", "xla_plain", "lean"])
    ap.add_argument("--profile_dir", type=str, default=None)
    ap.add_argument("--n_shards", type=int, default=1)
    ap.add_argument("--shard_layout", type=str, default="halo",
                    choices=["halo", "edgeshard"])
    ap.add_argument("--halo_overlap", action="store_true", default=False)
    # where the run goes: the card (default) or the plain versions on the
    # CPU
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def load_bridged_graph(path: str):
    if path.endswith(".npz"):
        return load_graph_npz(path)
    return load_pyg_data_dict(path)


def main(args):
    data = load_bridged_graph(args.path_data)
    if is_primary():
        print("local homophily of test nodes:", eval_bridged_graph(data))

    save_best_path = None
    if args.save:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        gnn = "GraphSAGE" if args.no_dtc else args.model_name
        save_best_path = os.path.join(
            args.ckpt_dir, f"model_{gnn}_{args.dataset_name}_best.pkl"
        )
    common = dict(
        num_layer=args.num_layer, hidden=args.hidden_dim,
        num_epoch=args.num_epoch, metric=args.eval_metric,
        to_undirected=args.to_undirected, seed=args.seed,
        log_every=args.log_every, save_best_path=save_best_path,
        matmul_precision=args.matmul_precision,
        message_dtype=args.message_dtype, scan_epochs=args.scan_epochs,
        check_numerics=args.check_numerics)
    if args.no_dtc:
        # the reference's no_dtc recipe: GraphSAGE without the scheduler
        # (reference main_graph_knowledge_transfer.py:414-421)
        cfg = Stage2Config(model_name="GraphSAGE", use_scheduler=False,
                           **common)
    else:
        cfg = Stage2Config(model_name=args.model_name,
                           memory_policy=args.memory_policy,
                           n_shards=args.n_shards,
                           shard_layout=args.shard_layout,
                           halo_overlap=args.halo_overlap, **common)
    if args.profile_dir:
        with trace(args.profile_dir, args.device):
            res = train_ktgnn(data, cfg, device=args.device)
        print(f"profiler trace written to {args.profile_dir}")
    else:
        res = train_ktgnn(data, cfg, device=args.device)
    if is_primary():
        print("[stage-2 best]", {k: v for k, v in res["best"].items()
                                 if k != "per_head"})
        if "per_head" in res["best"]:
            print("[per-head test]", res["best"]["per_head"])
        print(f"mean s/epoch: {res['mean_epoch_time']:.4f}")
    return res


def cli_entry():
    main(build_argparser().parse_args())


if __name__ == "__main__":
    cli_entry()
