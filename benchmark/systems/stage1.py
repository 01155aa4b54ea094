"""The port's stage 1 as the harness drives it: whole training runs through
``train_adversarial`` on the two domains of the configuration's graph,
and the recorder that reads, from inside the window's first run, what the
reference needs to follow it.

This file, ``systems/ktgnn.py`` and the traffic generators are the only
parts of the benchmark that import the port (``bridged_gnn_tpu_torch``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from bridged_gnn_tpu_torch.train import stage1 as program
from bridged_gnn_tpu_torch.train.stage1 import (
    DeviceStage1Evaluator,
    Stage1Config,
    segment_bounds,
    train_adversarial,
)
from data.domains import split_domains
from lib.spec import load_module

ref = load_module("reference", "stage1")

# the model's attribute each part sits under, by the part's class name
PARTS = {"SourceLearnerV2": "source", "TargetLearnerAEV2": "target",
         "Discriminator": "disc"}


def stage1_config(config: dict, seed: int, **changes) -> Stage1Config:
    fields = {f.name for f in dataclasses.fields(Stage1Config)}
    settings = {k: v for k, v in config["stage1"].items() if k in fields}
    return Stage1Config(**{**settings, "seed": seed, **changes})


def train_call(src: dict, tar: dict, config: dict, seed: int, device: str,
               **changes) -> dict:
    """One whole stage-1 run of the configuration's recipe; what the
    harness keeps of it: times, each epoch's losses, the best epoch and
    its weights."""
    cfg = stage1_config(config, seed, **changes)
    t0 = time.perf_counter()
    out = train_adversarial(src, tar, cfg, device=device)
    wall = time.perf_counter() - t0
    return dict(wall_s=wall, total_time=out.get("total_time"),
                mean_epoch_time=out["throughput"]["mean_s"],
                epochs=len(out["history"]),
                history_epochs=[h["epoch"] for h in out["history"]],
                losses=[(h["loss"], h["loss_d"], h["loss_ae"])
                        for h in out["history"]],
                best_epoch=int(out["best"]["epoch"]),
                state_dict=out["state_dict"],
                captures=(out["scan"] or {}).get("captures"))


class Recorder:
    """Taps on one stage-1 run that read what the comparison needs and work
    alike in an eager epoch and inside a CUDA graph's replay: each tap is
    a device operation that writes into buffers made in the first epoch,
    before any capture, at the slot that an epoch counter on the device
    looks up. Each sampled epoch has a slot of its own; every other epoch
    writes into one spare slot.

    The counter advances where an epoch draws its pairs (a wrapper of
    ``sample_epoch_on_device``), which also keeps the pairs, their targets
    and a tag of the epoch. Per sampled epoch besides: each part's weights
    (and the pair head's batch-norm statistics) as its first training
    forward of the epoch starts (global pre-hooks on ``SourceLearnerV2``,
    ``TargetLearnerAEV2``, ``Discriminator``); every dropout mask of the
    step, as the zeros of the input of the linear after it, bit by bit,
    and its values at ``mask_samples`` seeded positions; each Adam's
    moments and step count before its step and its part after it (global
    optimizer hooks). After every evaluation epoch's last step, the whole
    state (a second table), for the returned best weights. At the
    evaluation epochs ``checked`` the device evaluator's pairs and counts
    (wrappers of ``DeviceStage1Evaluator.draw`` and ``_counts``, which run
    eagerly): a fixed number of them, so that what the recorder holds, and
    the window's peak memory with it, is the same for every seed."""

    def __init__(self, epochs: List[int], evals: List[int],
                 checked: List[int], num_epoch: int, mask_samples: int,
                 seed: int, device: str):
        self.epochs, self.evals = sorted(epochs), sorted(evals)
        k = len(self.epochs)
        self.table = self._table(self.epochs, num_epoch, device)
        self.etable = self._table(self.evals, num_epoch, device)
        self.eval_sampled = set(checked)
        self.t = torch.zeros(1, dtype=torch.int64, device=device)
        self.tags = torch.zeros(k + 1, dtype=torch.int64, device=device)
        self.bits = (2 ** torch.arange(8)).to(torch.uint8).to(device)
        self.mask_samples, self.seed, self.device = mask_samples, seed, device
        self.parts: Dict[str, torch.nn.Module] = {}
        self.layout: Dict[str, list] = {}       # part -> [(name, tensor)]
        self.opts: Dict[int, str] = {}          # id(optimizer) -> part
        self.sites: Dict[int, str] = {}         # id(linear) -> site
        self.buf: Dict[str, torch.Tensor] = {}
        self.positions: Dict[str, torch.Tensor] = {}
        self.shapes: Dict[str, tuple] = {}      # site -> its input's shape
        self.pair_sizes: List[int] = []
        self.eval_pairs: dict = {}
        self.eval_counts: dict = {}
        self.clf_calls = 0
        self.handles, self.patched = [], []

    @staticmethod
    def _table(epochs, num_epoch, device):
        table = torch.full((num_epoch + 2,), len(epochs), dtype=torch.int64)
        table[torch.as_tensor(epochs, dtype=torch.int64)] = torch.arange(
            len(epochs))
        return table.to(device)

    # ----------------------------------------------------------- plumbing

    def __enter__(self):
        from torch.nn.modules.module import register_module_forward_pre_hook
        from torch.optim.optimizer import (
            register_optimizer_step_post_hook,
            register_optimizer_step_pre_hook,
        )

        self.handles = [register_module_forward_pre_hook(self._module_pre),
                        register_optimizer_step_pre_hook(self._step_pre),
                        register_optimizer_step_post_hook(self._step_post)]
        self._patch(program, "sample_epoch_on_device", self._draw_pairs)
        self._patch(DeviceStage1Evaluator, "draw", self._eval_draw)
        self._patch(DeviceStage1Evaluator, "_counts", self._eval_counts)
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        for owner, name, plain in reversed(self.patched):
            setattr(owner, name, plain)
        self.handles, self.patched = [], []

    def _patch(self, owner, name, make):
        plain = getattr(owner, name)
        self.patched.append((owner, name, plain))
        setattr(owner, name, make(plain))

    def _slot(self) -> torch.Tensor:
        return self.table.index_select(0, self.t)

    def _zeros(self, key, rows, width, dtype=torch.float32):
        if key not in self.buf:
            self.buf[key] = torch.zeros(rows, width, dtype=dtype,
                                        device=self.device)
        return self.buf[key]

    @staticmethod
    def _flat(tensors) -> torch.Tensor:
        return torch.cat([x.detach().reshape(-1).float() for x in tensors])

    def _state(self, part: str) -> torch.Tensor:
        return self._flat([x for _, x in self.layout[part]])

    def _params(self, part: str) -> List[torch.Tensor]:
        return list(self.parts[part].parameters())

    # ------------------------------------------------------------- taps

    def _draw_pairs(self, plain):
        def draw(samplers, labels, gen):
            idxs, y = plain(samplers, labels, gen)
            self.t += 1
            slot = self._slot()
            rows = len(self.epochs) + 1
            self.tags.index_copy_(0, slot, self.t)
            flat = torch.cat([idxs[k] for k in ref.PAIR_KEYS])
            targets = torch.cat([y[r] for r in ref.RELATIONS])
            if not self.pair_sizes:
                self.pair_sizes = [len(idxs[k]) for k in ref.PAIR_KEYS]
            self._zeros("pairs", rows, flat.numel(), torch.int64) \
                .index_copy_(0, slot, flat[None])
            self._zeros("targets", rows, targets.numel()) \
                .index_copy_(0, slot, targets[None].float())
            return idxs, y
        return draw

    def _attach(self, module, part: str) -> None:
        prefix = ref.PARTS[part]
        self.parts[part] = module
        self.layout[part] = (
            [(prefix + k, p) for k, p in module.named_parameters()]
            + [(prefix + k, b) for k, b in module.named_buffers()
               if ref.is_buffer(k)])
        net = {"source": "backbone_net", "target": "encoder"}.get(part)
        if net is not None:
            mlp = getattr(module, net)
            if not hasattr(mlp, "layers"):
                raise RuntimeError(f"the {part} part has no MLP {net}")
            site = {"source": "source.backbone",
                    "target": "target.encoder"}[part]
            for i, layer in enumerate(mlp.layers):
                if i:
                    self.sites[id(layer)] = f"{site}.{i}"
        if part == "source":
            self.sites[id(module.sim_net.lin_clf)] = "clf"

    def _module_pre(self, module, args) -> None:
        if not module.training:
            return
        kind = type(module).__name__
        part = PARTS.get(kind)
        if part is not None:
            if part not in self.parts:
                self._attach(module, part)
            if module is not self.parts[part]:
                return
            if part == "source":
                self.clf_calls = 0
            state = self._state(part)
            self._zeros(f"before.{part}", len(self.epochs) + 1,
                        state.numel()).index_copy_(0, self._slot(),
                                                   state[None])
            return
        site = self.sites.get(id(module))
        if site is None:
            return
        if site == "clf":
            if self.clf_calls > 1:
                return
            site = ("clf.source", "clf.target")[self.clf_calls]
            self.clf_calls += 1
        x = args[0].detach()
        rows = len(self.epochs) + 1
        if site not in self.positions:
            rng = np.random.default_rng([self.seed, 4, len(self.positions)])
            self.positions[site] = torch.as_tensor(np.sort(rng.choice(
                x.numel(), size=min(self.mask_samples, x.numel()),
                replace=False)), device=x.device)
            self.shapes[site] = tuple(x.shape)
        slot = self._slot()
        bits = (x != 0).reshape(-1, 8).to(torch.uint8) * self.bits
        self._zeros(f"mask.{site}", rows, x.numel() // 8, torch.uint8) \
            .index_copy_(0, slot,
                         bits.sum(1, dtype=torch.int32).to(torch.uint8)[None])
        self._zeros(f"values.{site}", rows, len(self.positions[site])) \
            .index_copy_(0, slot, x.reshape(-1).index_select(
                0, self.positions[site]).float()[None])

    def _part_of(self, opt) -> str:
        if id(opt) not in self.opts:
            theirs = {id(p) for g in opt.param_groups for p in g["params"]}
            self.opts[id(opt)] = next(
                (part for part in self.parts
                 if {id(p) for p in self._params(part)} == theirs), "")
        return self.opts[id(opt)]

    def _step_pre(self, opt, args, kwargs) -> None:
        part = self._part_of(opt)
        if not part:
            return
        slot, rows = self._slot(), len(self.epochs) + 1
        params = self._params(part)
        for key in ("exp_avg", "exp_avg_sq"):
            # before the first step Adam has no state: zero moments
            flat = self._flat([opt.state[p][key] if key in opt.state.get(p, {})
                               else torch.zeros_like(p) for p in params])
            self._zeros(f"{key}.{part}", rows, flat.numel()) \
                .index_copy_(0, slot, flat[None])
        first = opt.state.get(params[0], {})
        step = self._zeros(f"step.{part}", rows, 1, torch.float64)
        if "step" in first:
            step.index_copy_(0, slot, torch.as_tensor(
                first["step"], device=self.device).reshape(1, 1).double())
        else:
            step.index_fill_(0, slot, 0.0)

    def _step_post(self, opt, args, kwargs) -> None:
        part = self._part_of(opt)
        if not part:
            return
        state = self._state(part)
        self._zeros(f"after.{part}", len(self.epochs) + 1,
                    state.numel()).index_copy_(0, self._slot(), state[None])
        if part == "disc" and len(self.parts) == len(PARTS):
            whole = torch.cat([self._state(q) for q in sorted(self.parts)])
            self._zeros("eval_state", len(self.evals) + 1, whole.numel()) \
                .index_copy_(0, self.etable.index_select(0, self.t),
                             whole[None])

    def _eval_draw(self, plain):
        def draw(evaluator, split, epoch=0):
            pairs = plain(evaluator, split, epoch)
            if epoch in self.eval_sampled:
                self.eval_pairs[(split, epoch)] = {
                    rel: (a.clone(), b.clone())
                    for rel, (a, b) in pairs.items()}
            return pairs
        return draw

    def _eval_counts(self, plain):
        def counts(evaluator, z_src, z_tar, split, epoch):
            out = plain(evaluator, z_src, z_tar, split, epoch)
            if epoch in self.eval_sampled:
                self.eval_counts[(split, epoch)] = out.clone()
            return out
        return counts

    # ------------------------------------------------------------ reading

    def _named(self, row: torch.Tensor, parts) -> Dict[str, torch.Tensor]:
        out, at = {}, 0
        for part in parts:
            for name, x in self.layout[part]:
                out[name] = row[at: at + x.numel()].reshape(x.shape)
                at += x.numel()
        return out

    def read(self) -> dict:
        """What the taps wrote, by sampled epoch, weights by name."""
        if len(self.parts) != len(PARTS) or "pairs" not in self.buf:
            raise RuntimeError("the recorder saw no stage-1 training step "
                               f"(parts {sorted(self.parts)})")
        if self.t.device.type == "cuda":
            torch.cuda.synchronize()
        rows = len(self.epochs) + 1
        for part in PARTS.values():
            # a part whose Adam never stepped reads zeros, which no
            # comparison passes
            width = sum(x.numel() for _, x in self.layout[part])
            self._zeros(f"after.{part}", rows, width)
            width = sum(p.numel() for p in self._params(part))
            for key in ("exp_avg", "exp_avg_sq"):
                self._zeros(f"{key}.{part}", rows, width)
            self._zeros(f"step.{part}", rows, 1, torch.float64)
        out = dict(epochs=self.epochs, evals=self.evals,
                   tags=self.tags.tolist()[:-1], epochs_run=int(self.t),
                   positions=self.positions, before={}, after={}, m={},
                   v={}, step={}, masks={}, values={}, pairs={},
                   targets={}, eval_pairs=self.eval_pairs,
                   eval_counts=self.eval_counts, shapes=self.shapes)
        splits = np.cumsum(self.pair_sizes)[:-1].tolist()
        n_pairs = self.pair_sizes[::2]
        for j, t in enumerate(self.epochs):
            before, after, m, v = {}, {}, {}, {}
            for part in PARTS.values():
                before.update(self._named(self.buf[f"before.{part}"][j],
                                          [part]))
                after.update(self._named(self.buf[f"after.{part}"][j],
                                         [part]))
                params = [(k, x) for k, x in self.layout[part]
                          if not ref.is_buffer(k)]
                for key, into in (("exp_avg", m), ("exp_avg_sq", v)):
                    row, at = self.buf[f"{key}.{part}"][j], 0
                    for k, x in params:
                        into[k] = row[at: at + x.numel()].reshape(x.shape)
                        at += x.numel()
            out["before"][t], out["after"][t] = before, after
            out["m"][t], out["v"][t] = m, v
            out["step"][t] = {part: int(self.buf[f"step.{part}"][j, 0])
                              for part in PARTS.values()}
            out["masks"][t] = {s: self.buf[f"mask.{s}"][j]
                               for s in self.positions}
            out["values"][t] = {s: self.buf[f"values.{s}"][j]
                                for s in self.positions}
            out["pairs"][t] = dict(zip(ref.PAIR_KEYS, torch.tensor_split(
                self.buf["pairs"][j], splits)))
            out["targets"][t] = dict(zip(ref.RELATIONS, torch.tensor_split(
                self.buf["targets"][j], np.cumsum(n_pairs)[:-1].tolist())))
        rows = self.buf.get("eval_state")
        order = sorted(self.parts)
        out["eval_state"] = {
            e: self._named(rows[i], order) for i, e in enumerate(self.evals)
        } if rows is not None else {}
        return out


def eval_epochs(config: dict) -> List[int]:
    c = config["stage1"]
    return [e for e in range(c["start_eval_epoch"], c["num_epoch"] + 1)
            if e % c["eval_per_epoch"] == 0]


def checked_evals(config: dict) -> List[int]:
    """The evaluations the comparison recomputes: the first two, the
    middle one and the last."""
    evals = eval_epochs(config)
    if not evals:
        return []
    return sorted({*evals[:2], evals[len(evals) // 2], evals[-1]})


def sampled_epochs(config: dict, traffic: dict, seed: int) -> List[int]:
    """The epochs the comparison follows: the first ``start_steps``; the
    first epoch of the second segment (a replay after the first segment's
    copy to the host) and one inside the middle segment of those longer
    than an epoch; the evaluations of :func:`checked_evals`; the last; and
    ``random_epochs`` more drawn from the seed."""
    cfg = stage1_config(config, seed)
    last = cfg.num_epoch
    fixed = set(range(1, traffic["start_steps"] + 1)) | {last}
    long = [s for s in segment_bounds(1, cfg) if s[1] > s[0]]
    if len(long) > 1:
        mid = long[len(long) // 2]
        fixed |= {long[1][0], (mid[0] + mid[1] + 1) // 2}
    fixed |= set(checked_evals(config))
    rest = sorted(set(range(1, last + 1)) - fixed)
    rng = np.random.default_rng([seed, 3])
    drawn = rng.choice(rest, size=min(traffic["random_epochs"], len(rest)),
                       replace=False) if rest else []
    return sorted(fixed | {int(t) for t in drawn})


# ------------------------------------------------------- the harness's calls


def setup(kind: str, data: Dict[str, np.ndarray], config: dict,
          traffic: dict, seed: int, device: str) -> dict:
    """Everything before the window: the two domains, a short run through
    the same entry (eager epochs, the capture, replays, two evaluations:
    ``traffic["warmup"]``), which warms the allocator, cuBLAS and the
    evaluator, and the window's recorder."""
    if kind != "train_runs":
        raise ValueError(f"stage 1 has no {kind!r} traffic")
    src, tar = split_domains(data, seed)
    train_call(src, tar, config, seed, device, **traffic["warmup"])
    recorder = Recorder(sampled_epochs(config, traffic, seed),
                        eval_epochs(config), checked_evals(config),
                        config["stage1"]["num_epoch"],
                        traffic["mask_samples"], seed, device)
    return dict(src=src, tar=tar, config=config, seed=seed, device=device,
                recorder=recorder)


def call(state: dict, i: int) -> dict:
    """Training run ``i`` of the window, with the seed ``seed + i``; the
    first runs under the recorder, whose readings the comparison takes."""
    args = (state["src"], state["tar"], state["config"])
    if i:
        return train_call(*args, state["seed"] + i, state["device"])
    with state["recorder"]:
        return train_call(*args, state["seed"], state["device"])


def release(state: dict) -> None:
    """Nothing of the program's outlives a run."""
