"""Carry trained KT-GNN weights from the JAX package into the port.

``ktgnn_state_dict_from_flax`` takes the JAX ``{"params",
"batch_stats"}`` tree of a KTGNN (as nested dicts of numpy arrays — the
stage-2 CLI's ``--save`` pickle) and returns a state dict that
``bridged_gnn_tpu_torch.nn.ktgnn.KTGNN.load_state_dict(strict=True)``
accepts:

* flax Dense kernels ``[in, out]`` become weights ``[out, in]``;
* the ``a_f_*`` logit kernels ``[D, 1]`` become ``[D]`` vectors;
* ``bns_*`` and ``clf_transformer/bn_1`` scale, bias, mean and var become
  BatchNorm weight, bias, running_mean and running_var;
* ``convs_<i>``/``bns_<i>`` become ``convs.<i>``/``bns.<i>``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

_CONV_LINEARS = ("a_g_s2t", "a_g_t2s", "lin_t", "lin_s")
_CONV_VECTORS = ("a_f_t2s", "a_f_s2t")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _linear(sd: Dict[str, torch.Tensor], prefix: str,
            tree: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        sd[f"{prefix}.bias"] = _t(tree["bias"])


def _conv(sd, prefix: str, tree: Mapping[str, Any]) -> None:
    unknown = set(tree) - set(_CONV_LINEARS) - set(_CONV_VECTORS)
    if unknown:
        raise ValueError(f"{prefix}: unexpected parameters {sorted(unknown)}")
    for name in _CONV_LINEARS:
        _linear(sd, f"{prefix}.{name}", tree[name])
    for name in _CONV_VECTORS:
        kernel = np.asarray(tree[name]["kernel"])
        if kernel.ndim != 2 or kernel.shape[1] != 1:
            raise ValueError(
                f"{prefix}.{name}: expected a [D, 1] kernel, got "
                f"{list(kernel.shape)}")
        sd[f"{prefix}.{name}"] = _t(kernel[:, 0])


def _bn(sd, prefix: str, params: Mapping[str, Any],
        stats: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])


def ktgnn_state_dict_from_flax(
    variables: Mapping[str, Any]
) -> "OrderedDict[str, torch.Tensor]":
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key in sorted(params):
        tree = params[key]
        if key.startswith("convs_"):
            _conv(sd, f"convs.{int(key[len('convs_'):])}", tree)
        elif key.startswith("bns_"):
            _bn(sd, f"bns.{int(key[len('bns_'):])}", tree, stats[key])
        elif key in ("clf_base", "clf_target"):
            _conv(sd, key, tree)
        elif key == "clf_transformer":
            _linear(sd, "clf_transformer.lin_0", tree["lin_0"])
            _linear(sd, "clf_transformer.lin_3", tree["lin_3"])
            _bn(sd, "clf_transformer.bn_1", tree["bn_1"],
                stats["clf_transformer"]["bn_1"])
        else:
            raise ValueError(
                f"unexpected KT-GNN parameter group {key!r} (the feature "
                "complementor is not ported)")
    return sd
