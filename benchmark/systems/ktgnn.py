"""The port's KT-GNN as the harness drives it: whole training runs through
``train_ktgnn``, live predicts through ``KTGNNPredictor``, and the
recorder that reads, from inside the window's first run, what the
reference needs to follow it.

This file and the traffic drivers are the only parts of the benchmark
that import the port (``bridged_gnn_tpu_torch``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from bridged_gnn_tpu_torch.serve import KTGNNPredictor
from bridged_gnn_tpu_torch.train.stage2 import (
    Stage2Config,
    build_model,
    train_ktgnn,
)
from lib import traffic as mixes
from lib.spec import load_module


def stage2_config(config: dict, seed: int, **changes) -> Stage2Config:
    fields = {f.name for f in dataclasses.fields(Stage2Config)}
    settings = {k: v for k, v in config["stage2"].items() if k in fields}
    return Stage2Config(**{**settings, "seed": seed, **changes})


def train_call(data: Dict[str, np.ndarray], config: dict, seed: int,
               device: str, **changes) -> dict:
    """One whole training run of the configuration's recipe; what the
    harness keeps of it: times, and each epoch's loss and scores."""
    cfg = stage2_config(config, seed, **changes)
    t0 = time.perf_counter()
    out = train_ktgnn(data, cfg, device=device)
    wall = time.perf_counter() - t0
    return dict(wall_s=wall, total_time=out["total_time"],
                mean_epoch_time=out["mean_epoch_time"],
                epochs=len(out["history"]),
                losses=[h["loss"] for h in out["history"]],
                scores=[{k: h[k] for k in ("train", "val", "test")}
                        for h in out["history"]],
                final={k: v for k, v in out["state_dict"].items()})


class Recorder:
    """Taps on one training run that read what the comparison needs and
    work alike in an eager epoch and inside a CUDA graph's replay: each
    tap is a device operation that writes into buffers made before any
    capture, at the slot that an epoch counter on the device looks up.
    Each sampled epoch has a slot of its own, and every other epoch
    writes into one spare slot.

    Per sampled epoch t: the weights and batch-norm statistics the
    training forward starts from (a global pre-hook on ``KTGNN``), the
    dropout mask as the zeros of the embedding the heads take in, bit by
    bit, and its values at ``positions`` (on ``ClfTransformer``), Adam's
    moments and rate before the step and the weights after it (global
    optimizer hooks), and the epoch itself, so that an epoch that never
    ran leaves its slot's tag unwritten."""

    def __init__(self, epochs: List[int], num_epoch: int,
                 positions: np.ndarray, device: str):
        self.epochs = list(epochs)
        k = len(self.epochs)
        table = torch.full((num_epoch + 2,), k, dtype=torch.int64)
        table[torch.as_tensor(self.epochs)] = torch.arange(k)
        self.table = table.to(device)
        self.t = torch.ones(1, dtype=torch.int64, device=device)
        self.tags = torch.zeros(k + 1, dtype=torch.int64, device=device)
        self.lr = torch.zeros(k + 1, dtype=torch.float64, device=device)
        self.pos = torch.as_tensor(positions, dtype=torch.int64,
                                   device=device)
        self.bits = (2 ** torch.arange(8)).to(torch.uint8).to(device)
        self.model = self.opt = None
        self.packed = self.values = None
        self.handles = []

    def __enter__(self):
        from torch.nn.modules.module import register_module_forward_pre_hook
        from torch.optim.optimizer import (
            register_optimizer_step_post_hook,
            register_optimizer_step_pre_hook,
        )

        self.handles = [register_module_forward_pre_hook(self._module_pre),
                        register_optimizer_step_pre_hook(self._step_pre),
                        register_optimizer_step_post_hook(self._step_post)]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []

    def _slot(self) -> torch.Tensor:
        return self.table.index_select(0, self.t)

    @staticmethod
    def _flat(tensors) -> torch.Tensor:
        return torch.cat([x.detach().reshape(-1).float() for x in tensors])

    def _attach(self, model) -> None:
        self.model = model
        named = list(model.named_parameters())
        self.names = [k for k, _ in named]
        self.leaves = [p for _, p in named]
        stats = [(k, b) for k, b in model.named_buffers()
                 if k.endswith(("running_mean", "running_var"))]
        self.stat_names = [k for k, _ in stats]
        self.stats = [b for _, b in stats]
        rows = len(self.epochs) + 1
        dev = self.t.device
        width = sum(p.numel() for p in self.leaves)
        self.before = torch.zeros(
            rows, width + sum(b.numel() for b in self.stats), device=dev)
        self.m = torch.zeros(rows, width, device=dev)
        self.v = torch.zeros(rows, width, device=dev)
        self.after = torch.zeros(rows, width, device=dev)

    def _module_pre(self, module, args) -> None:
        if not module.training:
            return
        kind = type(module).__name__
        if kind == "KTGNN":
            if self.model is None:
                self._attach(module)
            if module is not self.model:
                return
            slot = self._slot()
            self.before.index_copy_(
                0, slot, self._flat(self.leaves + self.stats)[None])
            self.tags.index_copy_(0, slot, self.t)
        elif kind == "ClfTransformer" and self.model is not None:
            emb = args[0].detach()
            if self.packed is None:
                self.packed = torch.zeros(len(self.epochs) + 1,
                                          emb.numel() // 8,
                                          dtype=torch.uint8,
                                          device=emb.device)
                self.values = torch.zeros(len(self.epochs) + 1,
                                          len(self.pos), device=emb.device)
            slot = self._slot()
            bits = (emb != 0).reshape(-1, 8).to(torch.uint8) * self.bits
            self.packed.index_copy_(
                0, slot, bits.sum(1, dtype=torch.int32).to(torch.uint8)[None])
            self.values.index_copy_(
                0, slot, emb.reshape(-1).index_select(0, self.pos)
                .float()[None])

    def _step_pre(self, opt, args, kwargs) -> None:
        if self.opt is None:
            mine = {id(p) for p in self.leaves}
            theirs = {id(p) for g in opt.param_groups for p in g["params"]}
            if mine != theirs:
                raise RuntimeError("the optimizer does not step the "
                                   "model's parameters")
            self.opt = opt
        if opt is not self.opt:
            return
        slot = self._slot()
        for key, out in (("exp_avg", self.m), ("exp_avg_sq", self.v)):
            # before the first step Adam has no state: zero moments
            out.index_copy_(0, slot, self._flat([
                opt.state[p][key] if key in opt.state.get(p, {})
                else torch.zeros_like(p) for p in self.leaves])[None])
        lr = opt.param_groups[0]["lr"]
        if torch.is_tensor(lr):
            self.lr.index_copy_(0, slot, lr.reshape(1).double())
        else:
            self.lr.index_fill_(0, slot, float(lr))

    def _step_post(self, opt, args, kwargs) -> None:
        if opt is not self.opt:
            return
        self.after.index_copy_(0, self._slot(),
                               self._flat(self.leaves)[None])
        self.t += 1

    def read(self) -> dict:
        """What the taps wrote, by sampled epoch, weights by name."""
        if self.model is None or self.packed is None:
            raise RuntimeError("the recorder saw no KTGNN training forward "
                               "or no embedding reach the heads")
        if self.t.device.type == "cuda":
            torch.cuda.synchronize()
        sizes = [p.numel() for p in self.leaves]
        shapes = [p.shape for p in self.leaves]
        stat_sizes = [b.numel() for b in self.stats]

        def named(row, names, sizes, shapes=None):
            parts = torch.split(row[: sum(sizes)], sizes)
            return {k: (x.reshape(s) if shapes else x)
                    for k, x, s in zip(names, parts, shapes or sizes)}

        out = dict(epochs=self.epochs, tags=self.tags.tolist()[:-1],
                   epochs_run=int(self.t) - 1, positions=self.pos,
                   before={}, m={}, v={}, after={}, lr={}, packed={},
                   values={})
        for j, t in enumerate(self.epochs):
            w = named(self.before[j], self.names, sizes, shapes)
            w.update(named(self.before[j, sum(sizes):], self.stat_names,
                           stat_sizes))
            out["before"][t] = w
            out["m"][t] = named(self.m[j], self.names, sizes, shapes)
            out["v"][t] = named(self.v[j], self.names, sizes, shapes)
            out["after"][t] = named(self.after[j], self.names, sizes, shapes)
            out["lr"][t] = float(self.lr[j])
            out["packed"][t] = self.packed[j]
            out["values"][t] = self.values[j]
        return out


def sampled_epochs(config: dict, traffic: dict, seed: int) -> List[int]:
    """The epochs the comparison follows: the first ``start_steps``; the
    first epoch of every chunk after the first (a replay after the
    chunk's copy to the host) and of every StepLR period after the first;
    the last; and ``random_epochs`` more drawn from the seed."""
    c = config["stage2"]
    last = c["num_epoch"]
    fixed = set(range(1, traffic["start_steps"] + 1)) | {last}
    fixed |= set(range(c["scan_epochs"] + 1, last + 1, c["scan_epochs"]))
    if c["use_scheduler"]:
        fixed |= set(range(c["step_size"] + 1, last + 1, c["step_size"]))
    rest = sorted(set(range(1, last + 1)) - fixed)
    rng = np.random.default_rng([seed, 3])
    drawn = rng.choice(rest, size=min(traffic["random_epochs"], len(rest)),
                       replace=False) if rest else []
    return sorted(fixed | {int(t) for t in drawn})


def embedding_positions(n: int, hidden: int, count: int,
                        seed: int) -> np.ndarray:
    """``count`` distinct flat positions of the real rows of an [n,
    hidden] embedding, drawn from the seed."""
    rng = np.random.default_rng([seed, 4])
    return np.sort(rng.choice(n * hidden, size=min(count, n * hidden),
                              replace=False))


# ------------------------------------------------------------------ serving


def served_weights(data: Dict[str, np.ndarray], config: dict, seed: int,
                   device: str) -> Dict[str, torch.Tensor]:
    """Weights for serving the configuration's model on ``data``, made on
    ``device`` from ``seed`` in two draws, under the names and shapes of
    the reference's layers (the checkpoint's): every parameter
    ``U(±1/√fan_in)``; batch-norm scales ``1 ± 0.1``, shifts and running
    means ``± 0.1``, running variances ``1 ± 0.5``."""
    ref = load_module("reference", "ktgnn")
    hidden = config["stage2"]["hidden"]
    shapes = ref.param_shapes(data["x"].shape[1], hidden,
                              int(np.asarray(data["y"]).max()) + 1)
    bn_layers = ref.BN_LAYERS
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [int(np.prod(shape)) for _, shape, _ in shapes]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out = {}
    for (name, shape, fan_in), part in zip(shapes,
                                           torch.split(flat, sizes)):
        out[name] = part.reshape(shape) / float(np.sqrt(fan_in))
    u = torch.rand(len(bn_layers), 4, hidden, generator=gen,
                   device=device) * 2 - 1
    for i, bn in enumerate(bn_layers):
        out[f"{bn}.weight"] = 1 + 0.1 * u[i, 0]
        out[f"{bn}.bias"] = 0.1 * u[i, 1]
        out[f"{bn}.running_mean"] = 0.1 * u[i, 2]
        out[f"{bn}.running_var"] = 1 + 0.5 * u[i, 3]
    return out


def make_predictor(data: Dict[str, np.ndarray], config: dict,
                   weights: Dict[str, torch.Tensor],
                   device: str) -> KTGNNPredictor:
    cfg = stage2_config(config, 0)
    num_classes = int(np.asarray(data["y"]).max()) + 1
    model = build_model(cfg, num_classes, data["x"].shape[1], device)
    return KTGNNPredictor(model, weights, data,
                          to_undirected=cfg.to_undirected,
                          adjacency_method=cfg.adjacency_method,
                          device=device,
                          matmul_precision=cfg.matmul_precision)


def predict(predictor: KTGNNPredictor, request: dict) -> Dict[str, np.ndarray]:
    return predictor.predict_live(x=request["rows"], nodes=request["nodes"])


# ------------------------------------------------------- the harness's calls


def setup(kind: str, data: Dict[str, np.ndarray], config: dict,
          traffic: dict, seed: int, device: str) -> dict:
    """Everything before the window. ``train_runs``: a run of
    ``warmup_epochs`` epochs through the same entry (eager epochs, the
    capture, a replay), which loads the kernels and warms the allocator
    and cuBLAS, and the window's recorder. ``closed_loop``: the weights,
    the predictor (graph, layouts), the request pool and a few warm-up
    requests of the window's shape."""
    if kind == "train_runs":
        train_call(data, config, seed, device,
                   num_epoch=traffic["warmup_epochs"])
        hidden = config["stage2"]["hidden"]
        recorder = Recorder(
            sampled_epochs(config, traffic, seed),
            config["stage2"]["num_epoch"],
            embedding_positions(data["x"].shape[0], hidden,
                                traffic["embedding_samples"], seed),
            device)
        return dict(data=data, config=config, seed=seed, device=device,
                    recorder=recorder)
    weights = served_weights(data, config, seed, device)
    predictor = make_predictor(data, config, weights, device)
    pool = mixes.request_pool(traffic, *data["x"].shape, seed)
    for request in pool[: traffic["warmup_requests"]]:
        predict(predictor, request)
    return dict(weights=weights, predictor=predictor, pool=pool)


def call(state: dict, i: int) -> dict:
    """Training run ``i`` of the window, with the seed ``seed + i``; the
    first runs under the recorder, whose readings the comparison takes."""
    if i:
        return train_call(state["data"], state["config"], state["seed"] + i,
                          state["device"])
    with state["recorder"]:
        return train_call(state["data"], state["config"], state["seed"],
                          state["device"])


def request(state: dict, req: dict) -> Dict[str, np.ndarray]:
    return predict(state["predictor"], req)


def release(state: dict) -> None:
    """Drop the program's objects before the reference runs."""
    state.pop("predictor", None)
