"""Stage-2 training runtime: KT-GNN knowledge transfer on a bridged graph.

Port of ``bridged_gnn_tpu/train/stage2.py`` for KT-GNN on one device
(reference main_graph_knowledge_transfer.py:39-262):

  * 4-term loss ``(2·L_s + L_t + L_t̂)/4 + λ·KL(t̂ ‖ t)`` with the KL in
    torch ``kl_div(log_t̂, log_t, log_target=True, reduction='batchmean')``
    convention (lines 43-54);
  * Adam(lr 1e-3, wd 5e-3, torch L2 semantics) + StepLR(100, 0.1)
    (lines 205-207);
  * model selection by **minimum loss_clf_t2** (line 238), not val metric;
  * eval: source head on the train mask; distilled target-hat head on
    val/test (lines 73-118); per-head test scores (lines 119-142).

Each epoch is one train step (forward in train mode, loss, backward
through the attention kernels' autograd Functions, Adam, StepLR) and one
eval forward; only the predictions cross to the host. Options of the JAX
``Stage2Config`` that the port does not run yet raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from bridged_gnn_tpu_torch.graph import (
    Graph,
    coalesce_np,
    graph_from_dict,
    with_self_loops,
)
from bridged_gnn_tpu_torch.nn.ktgnn import KTGNN
from bridged_gnn_tpu_torch.ops.spmm import Adjacency, adjacency_from_graph
from bridged_gnn_tpu_torch.train.metrics import eval_metric
from bridged_gnn_tpu_torch.train.optim import make_optimizer
from bridged_gnn_tpu_torch.utils.platform import resolve_device
from bridged_gnn_tpu_torch.utils.profiling import EpochTimer


@dataclasses.dataclass
class Stage2Config:
    model_name: str = "KTGNN"
    num_layer: int = 2
    hidden: int = 64
    num_epoch: int = 300
    lr: float = 1e-3
    weight_decay: float = 5e-3
    use_scheduler: bool = True
    step_size: int = 100
    gamma: float = 0.1
    Lambda: float = 1.0
    dropout: float = 0.5
    use_bn: bool = True
    root_weight: bool = False
    metric: str = "f1"
    f1_average: str = "macro"
    seed: int = 0
    no_dtc: bool = False
    to_undirected: bool = False
    # 'auto' = one padded layout, or degree tiers when the skew rule fires
    adjacency_method: str = "auto"
    log_every: int = 0  # 0 = silent
    ckpt_dir: Optional[str] = None   # enable periodic checkpoints + resume
    ckpt_every: int = 50
    resume: bool = False
    save_best_path: Optional[str] = None  # pickle best-model variables
    # options of the JAX runtime the port does not run yet; any other
    # value than the default raises (see _NOT_PORTED)
    need_complement: bool = False
    scan_epochs: int = 0
    matmul_precision: Optional[str] = None
    message_dtype: Optional[str] = None
    memory_policy: str = "auto"
    check_numerics: bool = False
    n_shards: int = 1


# field, the values the port runs, the ROADMAP.md item that brings the rest
_NOT_PORTED = (
    ("model_name", ("KTGNN",), "Queue 1 item 8 (the model zoo)"),
    ("no_dtc", (False,), "Queue 1 item 8 (KTGNNNoDTC and the zoo)"),
    ("root_weight", (False,), "Queue 1 item 8 (model extras)"),
    ("need_complement", (False,), "Queue 1 item 8 (the complementor)"),
    ("message_dtype", (None,), "Queue 1 item 2 (bf16 messages)"),
    ("matmul_precision", (None, "highest", "float32"),
     "Queue 1 item 2 (bf16 messages)"),
    ("adjacency_method", ("auto", "blocked", "tiered"),
     "Queue 1 item 5 (the dense path)"),
    ("scan_epochs", (0,), "Queue 1 item 10 (training options)"),
    ("check_numerics", (False,), "Queue 1 item 10 (training options)"),
    ("memory_policy", ("auto", "plain"),
     "Queue 1 item 10 (training options)"),
    ("n_shards", (1,), "Queue 1 item 9 (multi-device)"),
)


def check_ported(cfg: Stage2Config) -> None:
    """Raise ``NotImplementedError`` for a value the port does not run."""
    for field, ported, item in _NOT_PORTED:
        value = getattr(cfg, field)
        if value not in ported:
            raise NotImplementedError(
                f"Stage2Config.{field}={value!r} is not ported (the port "
                f"runs {list(ported)}); see ROADMAP.md {item}")


def masked_nll(log_probs: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean of -log p(y) over masked nodes (torch F.nll_loss semantics)."""
    y_safe = y.clamp(min=0).long()
    picked = log_probs.gather(1, y_safe[:, None])[:, 0]
    m = mask.to(log_probs.dtype)
    return -(picked * m).sum() / m.sum().clamp(min=1.0)


def kl_batchmean(log_q: torch.Tensor, log_p: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """torch F.kl_div(log_q, log_p, log_target=True, reduction='batchmean')
    over masked rows: sum(exp(log_p)·(log_p − log_q)) / num_rows."""
    kl = torch.exp(log_p) * (log_p - log_q)
    num = (kl * mask.to(log_q.dtype)[:, None]).sum()
    return num / mask.sum().clamp(min=1)


def to_undirected_np(data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """PyG ToUndirected(merge=True): union of edges and reversed edges,
    coalesced (reference main_graph_knowledge_transfer.py:410-411)."""
    ei = data["edge_index"]
    both = np.concatenate([ei, ei[::-1]], axis=1)
    out = dict(data)
    out["edge_index"] = coalesce_np(both, data["x"].shape[0])
    return out


def prepare_stage2_graph(
    data: Dict[str, np.ndarray], cfg: Stage2Config, device="cuda",
) -> Tuple[Graph, Adjacency]:
    """The training graph on ``device`` (self loops added, as KT-GNN's
    graph partition does) and its adjacency: the ``node_block=128`` slot
    layout the predictor serves with, or degree tiers."""
    dev = resolve_device(device)
    data = dict(data)
    # reference quirk kept: unlabeled nodes can never be train
    # (main_graph_knowledge_transfer.py:404)
    data["train_mask"] = np.asarray(data["train_mask"]).copy()
    data["train_mask"][np.asarray(data["y"]) == -1] = False
    if cfg.to_undirected:
        data = to_undirected_np(data)
    g = with_self_loops(graph_from_dict(data)).to(dev)
    method = ("blocked" if cfg.adjacency_method == "auto"
              else cfg.adjacency_method)
    adj = adjacency_from_graph(g, method=method, node_block=128, device=dev)
    return g, adj


def build_model(cfg: Stage2Config, num_classes: int, in_channels: int,
                device="cuda") -> KTGNN:
    """KT-GNN with the torch-default init drawn from ``cfg.seed``, on
    ``device``. Only ``model_name='KTGNN'`` is ported."""
    if cfg.model_name != "KTGNN":
        raise ValueError(
            f"model {cfg.model_name!r} is not ported; only KTGNN is")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = KTGNN(
        num_classes=num_classes,
        in_channels=in_channels,
        layer_num=cfg.num_layer,
        hidden=cfg.hidden,
        dropout=cfg.dropout,
        use_bn=cfg.use_bn,
        generator=gen,
    )
    return model.to(dev)


def stage2_loss(model: KTGNN, g: Graph, adj: Adjacency, lam: float,
                generator: Optional[torch.Generator]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The stage-2 loss ``(2·L_s + L_t + L_t̂)/4 + λ·KL(t̂ ‖ t)`` of one
    train-mode forward (dropout from ``generator``, batch statistics),
    and its terms."""
    model.train()
    lp_s, lp_t, lp_that = model(g, adj, generator)
    tar_train = g.train_mask & ~g.central_mask
    aux = dict(
        loss_s=masked_nll(lp_s, g.y, g.train_mask),
        loss_t1=masked_nll(lp_t, g.y, tar_train),
        loss_t2=masked_nll(lp_that, g.y, tar_train),
        loss_kl=kl_batchmean(lp_that, lp_t, g.node_mask),
    )
    loss = ((2.0 * aux["loss_s"] + aux["loss_t1"] + aux["loss_t2"]) / 4.0
            + lam * aux["loss_kl"])
    return loss, aux


def train_step(model: KTGNN, g: Graph, adj: Adjacency,
               opt: torch.optim.Optimizer, lam: float,
               generator: Optional[torch.Generator]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One optimizer step on :func:`stage2_loss`. Returns the loss and its
    terms at the parameters before the step."""
    opt.zero_grad(set_to_none=True)
    loss, aux = stage2_loss(model, g, adj, lam, generator)
    loss.backward()
    opt.step()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def _eval_arrays(model: KTGNN, g: Graph, adj: Adjacency, need_probs: bool):
    """Eval-mode predictions of the three heads on the host, and their
    positive-class probabilities when ``need_probs`` (for auc)."""
    model.eval()
    with torch.no_grad():
        heads = model(g, adj)
        preds = torch.stack([lp.argmax(1) for lp in heads]).cpu().numpy()
        probs = (torch.stack([lp[:, 1].exp() for lp in heads]).cpu().numpy()
                 if need_probs else None)
    return preds, probs


def train_ktgnn(
    data: Dict[str, np.ndarray],
    cfg: Optional[Stage2Config] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Full stage-2 run on ``device``. Returns best scores, the history,
    timing diagnostics and the final weights (``state_dict``, on the
    CPU)."""
    cfg = cfg or Stage2Config()
    check_ported(cfg)
    dev = resolve_device(device)
    g, adj = prepare_stage2_graph(data, cfg, dev)
    num_classes = g.num_classes
    model = build_model(cfg, num_classes, g.num_features, dev)
    opt, sched = make_optimizer(
        model.parameters(), cfg.lr, cfg.weight_decay, cfg.use_scheduler,
        cfg.step_size, cfg.gamma)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    y_np = g.y.cpu().numpy()
    masks_np = {
        "train": g.train_mask.cpu().numpy(),
        "val": g.val_mask.cpu().numpy(),
        "test": g.test_mask.cpu().numpy(),
    }
    need_probs = cfg.metric == "auc"

    def evaluate():
        preds, probs = _eval_arrays(model, g, adj, need_probs)

        def score(head, mask):
            # probs: positive-class probability for auc (reference
            # main_graph_knowledge_transfer.py:88,102 uses column 1)
            return eval_metric(
                y_np[mask], preds[head][mask], cfg.metric, cfg.f1_average,
                probs_pos=None if probs is None else probs[head][mask])

        # source head for train, distilled target-hat head for val/test
        scores = {split: score(0 if split == "train" else 2, mask)
                  for split, mask in masks_np.items()}
        per_head = {name: score(h, masks_np["test"]) for h, name in
                    enumerate(("source", "target", "target_hat"))}
        return scores, per_head

    best = {"train": 0.0, "val": 0.0, "test": 0.0, "loss": 666.0,
            "epoch": -1}
    best_state = None
    history = []
    start_epoch = 1
    ckptr = None
    if cfg.ckpt_dir:
        from bridged_gnn_tpu_torch.train.checkpoint import TrainCheckpointer

        ckptr = TrainCheckpointer(cfg.ckpt_dir)
        raw = ckptr.restore() if cfg.resume else None
        if raw is not None:
            model.load_state_dict(raw["model"])
            opt.load_state_dict(raw["optimizer"])
            if sched is not None:
                sched.load_state_dict(raw["scheduler"])
            gen.set_state(raw["generator"])
            best = raw["best"]
            start_epoch = int(raw["epoch"]) + 1

    t_start = time.time()
    timer = EpochTimer(dev, num_edges=g.num_edges)
    for epoch in range(start_epoch, cfg.num_epoch + 1):
        with timer:
            loss, aux = train_step(model, g, adj, opt, cfg.Lambda, gen)
            if sched is not None:
                sched.step()
            loss, loss_t2 = float(loss), float(aux["loss_t2"])
            scores, per_head = evaluate()
        history.append(dict(epoch=epoch, loss=loss, loss_t2=loss_t2,
                            **scores))
        if cfg.log_every and epoch % cfg.log_every == 0:
            print(
                f"Epoch {epoch:03d} loss {loss:.4f} "
                f"train {scores['train']:.4f} val {scores['val']:.4f} "
                f"test {scores['test']:.4f}"
            )
        if loss_t2 < best["loss"]:
            best.update(
                train=scores["train"], val=scores["val"],
                test=scores["test"], loss=loss_t2, epoch=epoch,
                per_head=per_head,
            )
            if cfg.save_best_path:
                best_state = {k: v.detach().cpu().clone()
                              for k, v in model.state_dict().items()}
        if ckptr is not None and (
            epoch % cfg.ckpt_every == 0 or epoch == cfg.num_epoch
        ):
            ckptr.save(epoch, dict(
                model=model.state_dict(), optimizer=opt.state_dict(),
                scheduler=None if sched is None else sched.state_dict(),
                generator=gen.get_state(), best=best, epoch=epoch,
            ))

    if cfg.save_best_path and best_state is not None:
        from bridged_gnn_tpu_torch.io.flax_weights import (
            flax_variables_from_ktgnn_state_dict,
        )

        with open(cfg.save_best_path, "wb") as f:
            pickle.dump(flax_variables_from_ktgnn_state_dict(best_state), f)

    times = timer.times
    return dict(
        best=best,
        history=history,
        total_time=time.time() - t_start,
        mean_epoch_time=float(np.mean(times[2:] if len(times) > 2
                                      else times)) if times else 0.0,
        throughput=timer.summary(),
        state_dict={k: v.detach().cpu().clone()
                    for k, v in model.state_dict().items()},
        num_edges=g.num_edges,
    )
