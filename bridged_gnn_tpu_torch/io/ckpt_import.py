"""The reference's stage-1 checkpoints: its torch ``state_dict`` ⇄ the
port's ``AdversarialLearnerV2`` (port of ``bridged_gnn_tpu/io/
ckpt_import.py``, numpy only).

The reference writes ``ckpt/model_AdvLearner_{ds}_best.ckpt`` as a torch
``state_dict`` whose sequential modules are indexed (``lin_self.0``,
``convs.0``) and whose backbone is ``backbone``. The JAX package maps it
onto flax variables by a mechanical rename: indices join their module's
name (``lin_self_0``), ``backbone`` becomes ``backbone_net``, linear
weights are transposed and batch norms' running statistics go to the
``batch_stats`` collection. The port keeps those functions on nested
numpy dicts and goes from flax variables to its own modules through
``io/flax_weights.py``:

* :func:`load_reference_state_dict`: a reference ``state_dict`` → a state
  dict the port's model loads with ``strict=True``;
* :func:`flax_variables_to_torch_state_dict` and
  :func:`save_torch_state_dict`: the reference layout again, for the
  stage-1 CLI's ``--export_torch_ckpt``.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from bridged_gnn_tpu_torch.io.flax_weights import (
    flax_variables_from_state_dict,
    state_dict_from_flax,
)

_SEQ_MODULES = (
    "layers", "lin_self", "biasatt", "equavilent_trans_layer", "convs", "bns",
    "clf_transformer",
)


def _translate_path(parts) -> Tuple[str, ...]:
    """torch module path → flax module path (without the leaf)."""
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "backbone":
            out.append("backbone_net")
        elif (p in _SEQ_MODULES and i + 1 < len(parts)
              and parts[i + 1].isdigit()):
            if p == "clf_transformer":
                # torch Sequential: 0=Linear, 1=BN, 2=ReLU, 3=Linear
                out.append("clf_transformer")
                out.append({"0": "lin_0", "1": "bn_1",
                            "3": "lin_3"}[parts[i + 1]])
            else:
                out.append(f"{p}_{parts[i + 1]}")
            i += 1
        else:
            out.append(p)
        i += 1
    return tuple(out)


def _untranslate_path(parts: Tuple[str, ...]) -> Tuple[str, ...]:
    """flax module path → torch module path (inverse of
    :func:`_translate_path`)."""
    out = []
    for p in parts:
        if p == "backbone_net":
            out.append("backbone")
        elif out and out[-1] == "clf_transformer" and p in (
                "lin_0", "bn_1", "lin_3"):
            out.append(p.rsplit("_", 1)[1])
        else:
            stem, sep, idx = p.rpartition("_")
            if sep and stem in _SEQ_MODULES and idx.isdigit():
                out.extend((stem, idx))
            else:
                out.append(p)
    return tuple(out)


def _nest(flat: Dict[Tuple[str, ...], np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        tree = out
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = v
    return out


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def torch_state_dict_to_flax(sd: Mapping[str, Any]
                             ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) nested numpy dicts in the flax layout, from
    a reference ``state_dict`` (tensors or arrays)."""
    sd = {k: np.asarray(v.detach().cpu().numpy()
                        if isinstance(v, torch.Tensor) else v)
          for k, v in sd.items()}
    bn_prefixes = {k.rsplit(".", 1)[0] for k in sd
                   if k.endswith("running_mean")}
    params: Dict[Tuple[str, ...], np.ndarray] = {}
    batch_stats: Dict[Tuple[str, ...], np.ndarray] = {}
    for key, val in sd.items():
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        path = _translate_path(prefix.split("."))
        if prefix in bn_prefixes:
            if leaf in ("weight", "bias"):
                params[path + ({"weight": "scale"}.get(leaf, leaf),)] = val
            elif leaf in ("running_mean", "running_var"):
                batch_stats[path + (leaf[len("running_"):],)] = val
        elif leaf == "weight":
            params[path + ("kernel",)] = val.T if val.ndim == 2 else val
        elif leaf == "bias":
            params[path + ("bias",)] = val
    return _nest(params), _nest(batch_stats)


def load_reference_state_dict(model: nn.Module, sd: Mapping[str, Any]
                              ) -> "OrderedDict[str, torch.Tensor]":
    """A state dict that ``model`` (the port's ``AdversarialLearnerV2``)
    loads with ``strict=True``, from a reference AdvLearner
    ``state_dict``; raises on a missing, misshapen or unused tensor."""
    params, batch_stats = torch_state_dict_to_flax(sd)
    return state_dict_from_flax(
        model, {"params": params, "batch_stats": batch_stats})


def flax_variables_to_torch_state_dict(variables: Mapping[str, Any]
                                       ) -> Dict[str, np.ndarray]:
    """The reference AdvLearner ``state_dict`` layout from flax-layout
    variables (inverse of :func:`torch_state_dict_to_flax`): kernels
    transposed to ``[out, in]``, batch norms' ``scale`` as ``weight``,
    running statistics from ``batch_stats`` and a zero
    ``num_batches_tracked`` each (the reference never reads it). The
    reference loads it at main_bridged_graph.py:274."""
    sd: Dict[str, np.ndarray] = {}
    flat = dict(_flatten(variables.get("params", {})))
    bn_paths = {path[:-1] for path in flat if path[-1] == "scale"}
    for path, val in flat.items():
        prefix = ".".join(_untranslate_path(path[:-1]))
        arr = np.asarray(val)
        leaf = path[-1]
        if leaf == "scale":
            sd[f"{prefix}.weight"] = arr
        elif leaf == "kernel":
            sd[f"{prefix}.weight"] = arr.T if arr.ndim == 2 else arr
        elif leaf == "bias":
            sd[f"{prefix}.bias"] = arr
        else:
            raise KeyError(f"unexpected param leaf {path}")
    for path, val in _flatten(variables.get("batch_stats", {})):
        prefix = ".".join(_untranslate_path(path[:-1]))
        sd[f"{prefix}.running_{path[-1]}"] = np.asarray(val)
    for path in bn_paths:
        prefix = ".".join(_untranslate_path(path))
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
    return sd


def reference_state_dict(model: nn.Module,
                         state_dict: Mapping[str, torch.Tensor] = None
                         ) -> Dict[str, np.ndarray]:
    """``model``'s weights (or ``state_dict``) in the reference
    AdvLearner layout."""
    return flax_variables_to_torch_state_dict(flax_variables_from_state_dict(
        model, model.state_dict() if state_dict is None else state_dict))


def save_torch_state_dict(sd: Mapping[str, Any], path: str) -> None:
    """Write a ``{name: array}`` state dict as a torch pickle that the
    reference ``torch.load``s and ``load_state_dict``s as it is."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in sd.items()},
               path)
