"""Rank-side work of tests/test_torch_sharded.py: imports the port alone
(never JAX), so that the ranks ``parallel.multihost.spawn`` starts stay
light. Each function runs on every rank of one gloo group and returns
numpy arrays and numbers."""

import contextlib

import torch
import torch.distributed as dist

from bridged_gnn_tpu_torch.parallel.stage2_runtime import make_stage2_backend
from bridged_gnn_tpu_torch.train.stage2 import (
    Stage2Config,
    build_model,
    prepare_stage2_graph,
    resolve_memory_policy,
    train_ktgnn,
)


def step_state(model, loss, aux):
    """One step's loss terms, parameter gradients and BN statistics."""
    return dict(
        loss=float(loss), **{k: float(v) for k, v in aux.items()},
        grads={n: p.grad.numpy().copy()
               for n, p in model.named_parameters()},
        buffers={n: b.numpy().copy() for n, b in model.named_buffers()})


@contextlib.contextmanager
def kernel_calls():
    """Calls of each kernel wrapper inside the block, by wrapper and
    width: on CPU tensors a wrapper runs its plain version in place of
    the launch, so the plain versions count what a card would launch."""
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    counts, saved = {}, {}
    for fn in fk.KERNEL_WRAPPERS:
        name = f"{fn.__name__}_plain"
        saved[name] = plain = getattr(fk, name)

        def counting(*args, _wrapper=fn.__name__, _plain=plain, **kw):
            by_d = counts.setdefault(_wrapper, {})
            d = args[1].shape[-1]
            by_d[d] = by_d.get(d, 0) + 1
            return _plain(*args, **kw)

        setattr(fk, name, counting)
    try:
        yield counts
    finally:
        for name, plain in saved.items():
            setattr(fk, name, plain)


def sharded_step(data, kw):
    """One train step of the sharded backend ``kw`` names (an optimizer
    of rate 0 leaves the weights; the gradients stay on them) and its
    kernel calls (:func:`kernel_calls`)."""
    cfg = Stage2Config(**kw)
    g, _ = prepare_stage2_graph(data, cfg, "cpu", build_adj=False)
    model = build_model(cfg, g.num_classes, g.num_features, "cpu",
                        remat=resolve_memory_policy(cfg) == "lean")
    backend = make_stage2_backend(dist.group.WORLD, "cpu", model, g, cfg,
                                  g.num_classes)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    with kernel_calls() as calls:
        loss, aux = backend.train_step(opt, None)
    return dict(step_state(model, loss, aux), info=backend.info(),
                kernel_calls=calls)


def edge_spmm(data, kw):
    """``sharded_spmm`` of the graph's features and per-edge weights
    over this rank's edge span."""
    from bridged_gnn_tpu_torch.parallel.edgeshard import (
        edge_span,
        pad_graph_edges_for_sharding,
        shard_adjacency,
        sharded_spmm,
    )

    cfg = Stage2Config(**kw)
    g, _ = prepare_stage2_graph(data, cfg, "cpu", build_adj=False)
    n, q = dist.get_world_size(), dist.get_rank()
    g = pad_graph_edges_for_sharding(g, n)
    w = torch.linspace(0.5, 1.5, g.num_edges_padded)
    adj = shard_adjacency(g, n, q, dist.group.WORLD)
    return sharded_spmm(adj, g.x, w[edge_span(g, n, q)]).numpy()


def sharded_train(data, kw):
    """One sharded training run: its history, best epoch, final state."""
    res = train_ktgnn(data, Stage2Config(**kw), device="cpu")
    return dict(history=res["history"], best=res["best"],
                state={k: v.numpy() for k, v in res["state_dict"].items()},
                parallel=res["parallel"], scan=res["scan"])


def rank_work(data, step_cases, spmm_kw, train_cases):
    """Every case's sharded step, the edge-shard SpMM, then every
    training case's run. One thread a rank: the tensors are a few rows
    wide, and the ranks share the host with the other test processes."""
    torch.set_num_threads(1)
    out = {name: sharded_step(data, kw) for name, kw in step_cases.items()}
    out["spmm"] = edge_spmm(data, spmm_kw)
    out["train"] = {name: sharded_train(data, kw)
                    for name, kw in train_cases.items()}
    out["rank"] = dist.get_rank()
    return out
