"""Flax TIM params -> reference-layout torch ``state_dict``.

``detection_state_dict_from_jax`` and ``recognition_state_dict_from_jax``
are the exact inverses of ``tim_tpu/convert/torch_import.py::
{detection,recognition}_params_from_torch``: weights trained or converted
on the JAX side load into ``tim_tpu_torch.models.TimDetection`` /
``TimRecognition`` with ``load_state_dict(strict=True)``.
``quantized_{detection,recognition}_state_dict_from_jax`` do the same for
the int8 params of ``tim_tpu.ops.quant.quantize_params`` (the layout of
``ops.quant.quantize_state_dict``), and ``act_scales_from_jax`` renames
calibrated activation scales. ``swin_state_dict_from_jax`` and
``vit_state_dict_from_jax`` invert the backbones' ``params_from_torch``;
``two_head_state_dict_from_jax`` and ``mae_state_dict_from_jax`` convert
the training models (``runner.backbone.TwoHeadViT``,
``models.backbones.mae.PretrainVideoMAE``) the same way; and ``load_torch_checkpoint`` / ``load_backbone_state`` read a released
backbone checkpoint into a port backbone. Works on plain numpy leaves; jax
arrays convert through ``np.asarray``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _t(x, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype, copy=True))


def _linear(tree: Mapping, prefix: str, out: Dict) -> None:
    # flax kernel [in, out] -> torch weight [out, in]; an int8 kernel_q
    # keeps its dtype and brings its per-output-channel scale
    if "kernel_q" in tree:
        out[f"{prefix}.weight_q"] = _t(np.asarray(tree["kernel_q"]).T,
                                       np.int8)
        out[f"{prefix}.weight_scale"] = _t(tree["kernel_scale"])
    else:
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
    qkv = [attn[n] for n in ("q", "k", "v")]
    bias = _t(np.concatenate([np.asarray(p["bias"]) for p in qkv]))
    if "kernel_q" in attn["q"]:
        # int8: q/k/v rows packed into one Int8Dense, scales beside them
        out[f"{prefix}.self_attn.in_proj.weight_q"] = _t(np.concatenate(
            [np.asarray(p["kernel_q"]).T for p in qkv], axis=0), np.int8)
        out[f"{prefix}.self_attn.in_proj.weight_scale"] = _t(np.concatenate(
            [np.asarray(p["kernel_scale"]) for p in qkv]))
        out[f"{prefix}.self_attn.in_proj.bias"] = bias
    else:
        out[f"{prefix}.self_attn.in_proj_weight"] = _t(np.concatenate(
            [np.asarray(p["kernel"]).T for p in qkv], axis=0))
        out[f"{prefix}.self_attn.in_proj_bias"] = bias
    _linear(attn["out"], f"{prefix}.self_attn.out_proj", out)
    for name in ("norm1", "norm2"):
        _norm(tree[name], f"{prefix}.{name}", out)
    for name in ("linear1", "linear2"):
        _linear(tree[name], f"{prefix}.{name}", out)


_CLS_HEADS = {"fc_verb": "fc_visual_verb", "fc_noun": "fc_visual_noun",
              "fc_action": "fc_visual_action", "fc_audio": "fc_audio_action"}
_REG_HEADS = {"reg_visual": "fc_visual_action",
              "reg_audio": "fc_audio_action"}


def _trunk(p: Mapping, encoder: str, out: Dict,
           unprefixed_tokens: bool = False) -> None:
    """The shared trunk: time MLP, feature encoding, encoder (under the
    state-dict name ``encoder``), drloc MLP, AVGA pool."""
    _mlp(p["time_mlp"], "time_mlp", out)
    _norm(p["time_norm"], "time_mlp.6", out)
    for name, leaf in p["feature_encoding"].items():
        if name.endswith("_embedder"):
            key = f"feature_encoding.{name}"
            _linear(leaf["proj"], f"{key}.1", out)
            _norm(leaf["norm"], f"{key}.3", out)
            continue
        if unprefixed_tokens and name.endswith("_cls"):
            name = name.split("_", 1)[1]
        out[f"feature_encoding.{name}"] = _t(leaf)
    for i in range(len(p["encoder"])):
        _encoder_layer(p["encoder"][f"layer{i}"], f"{encoder}.layers.{i}",
                       out)
    _mlp(p["drloc_mlp"], "drloc_mlp", out)
    if "pool" in p:
        for name, tree in p["pool"].items():
            if "bias" in tree:
                _linear(tree, f"pool.{name}", out)
            else:
                out[f"pool.{name}.weight"] = _t(np.asarray(tree["kernel"]).T)


def detection_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` of a flax ``TimDetection`` -> reference-layout
    ``state_dict`` (fp32 CPU tensors; int8 ``weight_q`` where the tree
    holds ``kernel_q``)."""
    p = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    _trunk(p, "backbone", out)
    for name, tree in p["cls_head"].items():
        _linear(tree, f"cls_head.{_CLS_HEADS[name]}", out)
    for name, tree in p["reg_head"].items():
        _mlp(tree, f"reg_head.{_REG_HEADS[name]}", out)
    return out


def quantized_detection_state_dict_from_jax(qparams: Mapping
                                            ) -> Dict[str, torch.Tensor]:
    """The param tree of ``tim_tpu.ops.quant.quantize_params`` (the JAX
    quantized ``TimDetection``'s params, not wrapped in ``{'params':
    ...}``) -> the quantized port ``TimDetection``'s state dict: each int8
    ``kernel_q`` [in, out] becomes ``weight_q`` [out, in], q/k/v packed
    into ``self_attn.in_proj``."""
    return detection_state_dict_from_jax({"params": qparams})


def recognition_state_dict_from_jax(variables: Mapping
                                    ) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` of a flax ``TimRecognition`` -> the reference
    recognition ``state_dict`` (encoder ``transformer_encoder``, AVGA
    ``pool``). A model whose features and queries are of one modality
    names its CLS tokens without the modality prefix, as the reference
    (and ``models.tim.TimRecognition``) does."""
    p = variables["params"]
    fe = p["feature_encoding"]
    embedders = [n for n in fe if n.endswith("_embedder")]
    modalities = {n.split("_", 1)[0] for n in fe if n.endswith("_cls")}
    single = (len(embedders) == 1
              and modalities == {embedders[0].split("_", 1)[0]})
    out: Dict[str, torch.Tensor] = {}
    _trunk(p, "transformer_encoder", out, unprefixed_tokens=single)
    for name, tree in p["cls_head"].items():
        _linear(tree, f"cls_head.{_CLS_HEADS[name]}", out)
    return out


def quantized_recognition_state_dict_from_jax(qparams: Mapping
                                              ) -> Dict[str, torch.Tensor]:
    """The param tree of ``tim_tpu.ops.quant.quantize_params`` of a JAX
    ``TimRecognition`` -> the quantized port ``TimRecognition``'s state
    dict (as ``quantized_detection_state_dict_from_jax``)."""
    return recognition_state_dict_from_jax({"params": qparams})


_JAX_SCALE_PATHS = (
    (re.compile(r"^encoder/layer(\d+)/self_attn/(q|k|v)$"),
     r"{encoder}.layers.\1.self_attn.in_proj"),
    (re.compile(r"^encoder/layer(\d+)/self_attn/out$"),
     r"{encoder}.layers.\1.self_attn.out_proj"),
    (re.compile(r"^encoder/layer(\d+)/(linear[12])$"),
     r"{encoder}.layers.\1.\2"),
)


def act_scales_from_jax(act_scales, encoder: str = "backbone"
                        ) -> Tuple[Tuple[str, float], ...]:
    """The JAX package's calibrated (param path, scale) tuple
    (``quant.act_scales_tuple``; paths like
    ``'encoder/layer0/self_attn/q'``) -> the port's (module name, scale)
    tuple. q/k/v map onto the one packed ``in_proj`` and must carry the
    same scale (they see the same input); raises when they differ or a
    path has no port module. ``encoder``: the encoder's state-dict name,
    ``backbone`` (detection) or ``transformer_encoder`` (recognition)."""
    out: Dict[str, float] = {}
    for path, scale in act_scales:
        head = re.fullmatch(r"cls_head/(fc_\w+)", path)
        if head and head.group(1) in _CLS_HEADS:
            name = f"cls_head.{_CLS_HEADS[head.group(1)]}"
        else:
            for pattern, repl in _JAX_SCALE_PATHS:
                if pattern.match(path):
                    name = pattern.sub(repl.format(encoder=encoder), path)
                    break
            else:
                raise ValueError(f"act_scales_from_jax: no port module for "
                                 f"{path!r}")
        if name in out and out[name] != float(scale):
            raise ValueError(f"act_scales_from_jax: {name} gets scales "
                             f"{out[name]} and {float(scale)} (q/k/v "
                             f"differ)")
        out[name] = float(scale)
    return tuple(sorted(out.items()))


def _conv(tree: Mapping, prefix: str, out: Dict) -> None:
    # flax Conv kernel [t, h, w, in, out] -> torch [out, in, t, h, w]
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).transpose(
        4, 3, 0, 1, 2))
    out[f"{prefix}.bias"] = _t(tree["bias"])


def swin_state_dict_from_jax(variables: Mapping, depths=(2, 2, 18, 2)
                             ) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` of a flax ``SwinTransformer3D`` -> the
    reference trunk's ``state_dict`` (the inverse of
    ``swin3d.params_from_torch``)."""
    p = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    _conv(p["patch_embed"], "patch_embed.proj", out)
    if "patch_norm" in p:
        _norm(p["patch_norm"], "patch_embed.norm", out)
    for i, depth in enumerate(depths):
        for j in range(depth):
            src, dst = p[f"layer{i}_block{j}"], f"layers.{i}.blocks.{j}"
            _norm(src["norm1"], f"{dst}.norm1", out)
            _norm(src["norm2"], f"{dst}.norm2", out)
            attn = src["attn"]
            out[f"{dst}.attn.relative_position_bias_table"] = _t(
                attn["relative_position_bias_table"])
            _linear(attn["qkv"], f"{dst}.attn.qkv", out)
            _linear(attn["proj"], f"{dst}.attn.proj", out)
            _linear(src["fc1"], f"{dst}.mlp.fc1", out)
            _linear(src["fc2"], f"{dst}.mlp.fc2", out)
        if i < len(depths) - 1:
            down = p[f"layer{i}_downsample"]
            _norm(down["norm"], f"layers.{i}.downsample.norm", out)
            out[f"layers.{i}.downsample.reduction.weight"] = _t(
                np.asarray(down["reduction"]["kernel"]).T)
    _norm(p["norm"], "norm", out)
    return out


def vit_state_dict_from_jax(variables: Mapping, depth: int = 24
                            ) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` of a flax ``VideoMAEViT`` -> the reference
    checkpoint's ``state_dict`` (the inverse of ``vit.params_from_torch``;
    no classifier head)."""
    p = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    _conv(p["patch_embed"], "patch_embed.proj", out)
    _norm(p["fc_norm"], "fc_norm", out)
    for i in range(depth):
        _vit_block(p[f"block{i}"], f"blocks.{i}", out)
    return out


def _vit_block(src: Mapping, dst: str, out: Dict) -> None:
    _norm(src["norm1"], f"{dst}.norm1", out)
    _norm(src["norm2"], f"{dst}.norm2", out)
    attn = src["attn"]
    out[f"{dst}.attn.qkv.weight"] = _t(np.asarray(attn["qkv_kernel"]).T)
    out[f"{dst}.attn.q_bias"] = _t(attn["q_bias"])
    out[f"{dst}.attn.v_bias"] = _t(attn["v_bias"])
    _linear(attn["proj"], f"{dst}.attn.proj", out)
    _linear(src["fc1"], f"{dst}.mlp.fc1", out)
    _linear(src["fc2"], f"{dst}.mlp.fc2", out)
    if "gamma_1" in src:
        out[f"{dst}.gamma_1"] = _t(src["gamma_1"])
        out[f"{dst}.gamma_2"] = _t(src["gamma_2"])


def _count(tree: Mapping, pattern: str) -> int:
    return sum(1 for key in tree if re.fullmatch(pattern, key))


def two_head_state_dict_from_jax(variables: Mapping
                                 ) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` of a flax ``TwoHeadViT`` (a ``VideoMAEViT`` or
    ``SwinTransformer3D`` trunk; depths read off the tree) -> the port
    ``TwoHeadViT``'s state dict: the trunk's under ``trunk.``, the
    ``head_verb`` / ``head_noun`` Dense kernels as [out, in] weights."""
    p = variables["params"]
    trunk = p["trunk"]
    if "block0" in trunk:
        sd = vit_state_dict_from_jax({"params": trunk},
                                     _count(trunk, r"block\d+"))
    else:
        depths = []
        while _count(trunk, rf"layer{len(depths)}_block\d+"):
            depths.append(_count(trunk, rf"layer{len(depths)}_block\d+"))
        sd = swin_state_dict_from_jax({"params": trunk}, tuple(depths))
    out = {f"trunk.{k}": v for k, v in sd.items()}
    for head in ("head_verb", "head_noun"):
        _linear(p[head], head, out)
    return out


def mae_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` of a flax ``PretrainVideoMAE`` -> the port
    ``PretrainVideoMAE``'s state dict (encoder names as
    ``vit_state_dict_from_jax``'s)."""
    p = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    _conv(p["patch_embed"], "patch_embed.proj", out)
    for i in range(_count(p, r"block\d+")):
        _vit_block(p[f"block{i}"], f"blocks.{i}", out)
    _norm(p["encoder_norm"], "encoder_norm", out)
    out["encoder_to_decoder.weight"] = _t(
        np.asarray(p["encoder_to_decoder"]["kernel"]).T)
    out["mask_token"] = _t(p["mask_token"])
    for i in range(_count(p, r"decoder_block\d+")):
        _vit_block(p[f"decoder_block{i}"], f"decoder_blocks.{i}", out)
    _norm(p["decoder_norm"], "decoder_norm", out)
    _linear(p["decoder_head"], "decoder_head", out)
    return out


def load_torch_checkpoint(path: str):
    """A released torch checkpoint's state dict, unwrapped from ``trunk``,
    ``model``, ``state_dict`` or ``model_state`` as
    ``tim_tpu/extract/cli.py:72-79`` does. Like it, this unpickles the
    whole file (released checkpoints hold more than tensors): load only
    checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("trunk", "model", "state_dict", "model_state"):
        if isinstance(ckpt, dict) and key in ckpt:
            return ckpt[key]
    return ckpt


def load_backbone_state(model: torch.nn.Module, state_dict: Mapping
                        ) -> list:
    """Load a reference-layout state dict into a port backbone: every
    parameter of the model must be there (raises otherwise); keys the
    model has no use for (a classifier head, Swin's derived
    ``relative_position_index`` buffers) are skipped and returned."""
    missing, unexpected = model.load_state_dict(dict(state_dict),
                                                strict=False)
    if missing:
        raise KeyError(f"load_backbone_state: checkpoint lacks {missing}")
    return list(unexpected)
