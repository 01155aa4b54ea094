"""Carry trained weights between the JAX package and the port.

:func:`state_dict_from_flax` takes the JAX model's ``{"params",
"batch_stats"}`` tree (nested dicts of numpy arrays, as the stage-2 CLI's
``--save`` pickle holds it) and returns a state dict that the port
model's ``load_state_dict(strict=True)`` accepts, for KT-GNN, KTGNNNoDTC
and every model of ``nn/backbones.py``. The conversion is led by the
model's own modules:

* a module path ``convs.0.lin`` is the flax path ``convs_0/lin``;
* a linear's ``weight`` ``[out, in]`` is the transposed flax ``kernel``
  ``[in, out]``;
* a batch norm's ``weight``/``bias`` are the ``scale``/``bias`` params and
  its running statistics the ``batch_stats`` ``mean``/``var``; a layer
  norm's ``weight`` is its ``scale``;
* an AdaptedConv's ``a_f_*`` vectors ``[D]`` are ``[D, 1]`` kernels;
* any other parameter (GAT's ``att*`` ``[H, C]``, GIN's ``eps_i``,
  DeeperGCN's ``t_i``) keeps its name and shape.

:func:`flax_variables_from_state_dict` is its inverse: it gives the nested
numpy dicts of the JAX stage-2 ``--save`` pickle, so a checkpoint trained
by the port loads in both packages' serving CLIs.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from bridged_gnn_tpu_torch.nn.common import (
    GlorotLinear,
    MaskedBatchNorm,
    TorchLinear,
)
from bridged_gnn_tpu_torch.nn.ktgnn import AdaptedConv

_CONV_VECTORS = ("a_f_t2s", "a_f_s2t")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _flax_path(module_path: str) -> List[str]:
    """``convs.0.lin`` → ``["convs_0", "lin"]``: a ModuleList index joins
    its list's name as flax's ``name_{i}``."""
    out: List[str] = []
    for part in module_path.split(".") if module_path else []:
        if part.isdigit() and out:
            out[-1] = f"{out[-1]}_{part}"
        else:
            out.append(part)
    return out


def _transpose(a: np.ndarray) -> np.ndarray:
    return a.T.copy()


def _column(a: np.ndarray) -> np.ndarray:
    return a[:, None]


def _first_column(a: np.ndarray) -> np.ndarray:
    if a.ndim != 2 or a.shape[1] != 1:
        raise ValueError(f"expected a [D, 1] kernel, got {list(a.shape)}")
    return a[:, 0]


def _same(a: np.ndarray) -> np.ndarray:
    return a


# (state-dict key, flax collection, flax path, to flax, from flax)
_Entry = Tuple[str, str, List[str], Any, Any]


def _entries(model: nn.Module) -> Iterator[_Entry]:
    for mod_path, m in model.named_modules():
        fp = _flax_path(mod_path)
        pre = f"{mod_path}." if mod_path else ""
        if isinstance(m, (TorchLinear, GlorotLinear)):
            yield pre + "weight", "params", fp + ["kernel"], _transpose, \
                _transpose
            if m.bias is not None:
                yield pre + "bias", "params", fp + ["bias"], _same, _same
        elif isinstance(m, (MaskedBatchNorm, nn.LayerNorm)):
            yield pre + "weight", "params", fp + ["scale"], _same, _same
            yield pre + "bias", "params", fp + ["bias"], _same, _same
            if isinstance(m, MaskedBatchNorm):
                yield (pre + "running_mean", "batch_stats", fp + ["mean"],
                       _same, _same)
                yield (pre + "running_var", "batch_stats", fp + ["var"],
                       _same, _same)
        else:
            for name, _ in m.named_parameters(recurse=False):
                if isinstance(m, AdaptedConv) and name in _CONV_VECTORS:
                    yield (pre + name, "params", fp + [name, "kernel"],
                           _column, _first_column)
                else:
                    yield pre + name, "params", fp + [name], _same, _same


def _leaf_paths(variables: Mapping[str, Any]) -> Iterator[str]:
    """``params/convs_0/lin/kernel``, …: every leaf of the two
    collections, and every empty group inside them as a leaf of its own."""
    stack = [(c, variables[c]) for c in ("params", "batch_stats")
             if variables.get(c)]
    while stack:
        path, tree = stack.pop()
        if isinstance(tree, Mapping) and tree:
            stack.extend((f"{path}/{k}", v) for k, v in tree.items())
        else:
            yield path


def state_dict_from_flax(model: nn.Module, variables: Mapping[str, Any]
                         ) -> "OrderedDict[str, torch.Tensor]":
    """A state dict that ``model.load_state_dict(strict=True)`` accepts,
    from the JAX model's ``{"params", "batch_stats"}`` tree (nested dicts
    of arrays); raises on a missing, misshapen or unused flax leaf."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    want = model.state_dict()
    used = set()
    for key, coll, path, _, from_flax in _entries(model):
        tree = variables.get(coll, {})
        try:
            for p in path:
                tree = tree[p]
        except KeyError:
            raise ValueError(f"{key}: no flax {coll}/{'/'.join(path)}")
        t = _t(from_flax(np.asarray(tree)))
        if t.shape != want[key].shape:
            raise ValueError(f"{key}: flax {'/'.join(path)} has shape "
                             f"{list(t.shape)}, the model "
                             f"{list(want[key].shape)}")
        sd[key] = t
        used.add("/".join([coll] + path))
    unused = sorted(set(_leaf_paths(variables)) - used)
    if unused:
        raise ValueError(f"flax leaves that match no entry of the model: "
                         f"{unused}")
    if set(sd) != set(want):
        raise ValueError(f"model entries with no flax leaf: "
                         f"{sorted(set(want) - set(sd))}")
    return sd


def flax_variables_from_state_dict(
    model: nn.Module, state_dict: Mapping[str, torch.Tensor]
) -> Dict[str, Dict[str, Any]]:
    """``{"params", "batch_stats"}`` nested dicts of numpy arrays, the
    layout of the JAX stage-2 ``--save`` pickle, from ``model``'s state
    dict (``state_dict``, e.g. the best epoch's)."""
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, coll, path, to_flax, _ in _entries(model):
        tree = out[coll]
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = to_flax(_np(state_dict[key]))
    return out
