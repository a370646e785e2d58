"""Flax detection params -> reference-layout torch ``state_dict``.

The exact inverse of ``tim_tpu/convert/torch_import.py::
detection_params_from_torch``: weights trained or converted on the JAX
side load into ``tim_tpu_torch.models.TimDetection`` with
``load_state_dict(strict=True)``. Works on plain numpy leaves; jax arrays
convert through ``np.asarray``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _linear(tree: Mapping, prefix: str, out: Dict) -> None:
    # flax kernel [in, out] -> torch weight [out, in]
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    out[f"{prefix}.bias"] = _t(tree["bias"])


def _norm(tree: Mapping, prefix: str, out: Dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def _mlp(tree: Mapping, prefix: str, out: Dict) -> None:
    for i in range(len(tree)):
        _linear(tree[f"fc{i}"], f"{prefix}.{2 * i}", out)


def _encoder_layer(tree: Mapping, prefix: str, out: Dict) -> None:
    attn = tree["self_attn"]
    out[f"{prefix}.self_attn.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(attn[n]["kernel"]).T for n in ("q", "k", "v")], axis=0))
    out[f"{prefix}.self_attn.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(attn[n]["bias"]) for n in ("q", "k", "v")]))
    _linear(attn["out"], f"{prefix}.self_attn.out_proj", out)
    for name in ("norm1", "norm2"):
        _norm(tree[name], f"{prefix}.{name}", out)
    for name in ("linear1", "linear2"):
        _linear(tree[name], f"{prefix}.{name}", out)


_CLS_HEADS = {"fc_verb": "fc_visual_verb", "fc_noun": "fc_visual_noun",
              "fc_action": "fc_visual_action", "fc_audio": "fc_audio_action"}
_REG_HEADS = {"reg_visual": "fc_visual_action",
              "reg_audio": "fc_audio_action"}


def detection_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` of a flax ``TimDetection`` -> reference-layout
    ``state_dict`` (fp32 CPU tensors)."""
    p = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    _mlp(p["time_mlp"], "time_mlp", out)
    _norm(p["time_norm"], "time_mlp.6", out)
    for name, leaf in p["feature_encoding"].items():
        key = f"feature_encoding.{name}"
        if name.endswith("_embedder"):
            _linear(leaf["proj"], f"{key}.1", out)
            _norm(leaf["norm"], f"{key}.3", out)
        else:
            out[key] = _t(leaf)
    for i in range(len(p["encoder"])):
        _encoder_layer(p["encoder"][f"layer{i}"], f"backbone.layers.{i}", out)
    for name, tree in p["cls_head"].items():
        _linear(tree, f"cls_head.{_CLS_HEADS[name]}", out)
    for name, tree in p["reg_head"].items():
        _mlp(tree, f"reg_head.{_REG_HEADS[name]}", out)
    _mlp(p["drloc_mlp"], "drloc_mlp", out)
    return out
