"""Flax TIM params <-> reference-layout torch ``state_dict``.

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
``models.backbones.mae.PretrainVideoMAE``) the same way;
``slowfast_state_dict_from_jax`` inverts ``slowfast.params_from_torch``
(params and BatchNorm statistics); and ``load_torch_checkpoint`` /
``load_backbone_state`` read a released backbone checkpoint into a port
backbone. Works on plain numpy leaves; jax
arrays and CPU tensors convert through ``np.asarray``.

The other way, ``{detection,recognition,mae,vit}_params_to_jax`` take a
port state dict (``TimDetection``, ``TimRecognition``,
``PretrainVideoMAE``, ``VideoMAEViT``) and return the flax param tree
(not wrapped in ``{'params': ...}``) of CPU tensors: q/k/v unpacked from
``in_proj``, Dense kernels transposed, conv kernels permuted. They are
the port's copies of ``{detection,recognition}_params_from_torch`` and
of the ViT's ``params_from_torch``, and what ``train.checkpoint`` writes
the JAX package's msgpack files with.

Every converter here, in both directions, is a pure rearrangement of its
leaves: transposes, permutations, splits and concatenations, no
arithmetic (the ``*_from_jax`` functions store fp32, the dtype of every
training state, which an fp32 leaf passes unchanged). So a tree shaped
like the params, such as Adam's ``mu`` and ``nu``, converts through the
same functions, and a leaf converts bit for bit.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _strip_wrapper(sd: Mapping) -> Mapping:
    """Drop a uniform DataParallel/compile wrapper prefix if present (a
    copy of ``tim_tpu/convert/torch_import.py``'s). The reference saves
    ``model.module.state_dict()`` for multi-GPU runs, so released files
    should be bare, but files saved from a wrapped model still load."""
    changed = True
    while changed and sd:
        changed = False
        for prefix in ("module.", "_orig_mod."):
            if all(k.startswith(prefix) for k in sd):
                sd = {k[len(prefix):]: v for k, v in sd.items()}
                changed = True
    return sd


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


def _conv2d(tree: Mapping, prefix: str, out: Dict) -> None:
    # flax Conv kernel [h, w, in, out] -> torch [out, in, h, w]
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).transpose(
        3, 2, 0, 1))


def _batch_norm(params: Mapping, stats: Mapping, prefix: str,
                out: Dict) -> None:
    _norm(params, prefix, out)
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def slowfast_state_dict_from_jax(variables: Mapping,
                                 depths=(3, 4, 6, 3)
                                 ) -> Dict[str, torch.Tensor]:
    """``{'params', 'batch_stats'}`` of a flax ``AuditorySlowFast`` -> the
    reference checkpoint's ``state_dict`` (the inverse of
    ``slowfast.params_from_torch``; ``num_batches_tracked`` 0, which the
    JAX package does not keep)."""
    p, st = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    for i in (0, 1):
        name = f"s1_pathway{i}_stem"
        _conv2d(p[name]["conv"], f"s1.pathway{i}_stem.conv", out)
        _batch_norm(p[name]["bn"], st[name]["bn"], f"s1.pathway{i}_stem.bn",
                    out)
    for name in ("s1_fuse", "s2_fuse", "s3_fuse", "s4_fuse"):
        _conv2d(p[name]["conv_f2s"], f"{name}.conv_f2s", out)
        _batch_norm(p[name]["bn"], st[name]["bn"], f"{name}.bn", out)
    for s, depth in enumerate(depths):
        for i in (0, 1):
            for j in range(depth):
                src = f"s{s + 2}_pathway{i}_res{j}"
                dst = f"s{s + 2}.pathway{i}_res{j}"
                bp, bs = p[src]["branch2"], st[src]["branch2"]
                for leaf in ("a", "b", "c"):
                    _conv2d(bp[leaf], f"{dst}.branch2.{leaf}", out)
                    _batch_norm(bp[f"{leaf}_bn"], bs[f"{leaf}_bn"],
                                f"{dst}.branch2.{leaf}_bn", out)
                if "branch1" in p[src]:
                    _conv2d(p[src]["branch1"], f"{dst}.branch1", out)
                    _batch_norm(p[src]["branch1_bn"], st[src]["branch1_bn"],
                                f"{dst}.branch1_bn", out)
    _linear(p["projection"], "head.projection", out)
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


# ---------------------------------------------------------------------------
# port state dict -> flax param tree
# ---------------------------------------------------------------------------

def _leaf(t) -> torch.Tensor:
    return t.detach().cpu().contiguous()


def _linear_to_jax(sd: Mapping, prefix: str) -> Dict:
    return {"kernel": _leaf(sd[f"{prefix}.weight"].t()),
            "bias": _leaf(sd[f"{prefix}.bias"])}


def _norm_to_jax(sd: Mapping, prefix: str) -> Dict:
    return {"scale": _leaf(sd[f"{prefix}.weight"]),
            "bias": _leaf(sd[f"{prefix}.bias"])}


def _mlp_to_jax(sd: Mapping, prefix: str) -> Dict:
    """``{fc0, fc1, ...}`` of the linears at ``prefix.0``, ``prefix.2``,
    ... (a norm after them has a 1-d weight and ends the run)."""
    out, i = {}, 0
    while sd.get(f"{prefix}.{2 * i}.weight", torch.empty(0)).dim() == 2:
        out[f"fc{i}"] = _linear_to_jax(sd, f"{prefix}.{2 * i}")
        i += 1
    return out


def _indices(sd: Mapping, pattern: str) -> int:
    """The number of consecutive indices ``i`` from 0 for which some key
    starts with ``pattern.format(i)``."""
    n = 0
    while any(k.startswith(pattern.format(n)) for k in sd):
        n += 1
    return n


def _encoder_layer_to_jax(sd: Mapping, prefix: str) -> Dict:
    attn = f"{prefix}.self_attn"
    weights = sd[f"{attn}.in_proj_weight"].chunk(3, dim=0)
    biases = sd[f"{attn}.in_proj_bias"].chunk(3)
    out = {"self_attn": {
        name: {"kernel": _leaf(w.t()), "bias": _leaf(b)}
        for name, w, b in zip(("q", "k", "v"), weights, biases)}}
    out["self_attn"]["out"] = _linear_to_jax(sd, f"{attn}.out_proj")
    for name in ("norm1", "norm2"):
        out[name] = _norm_to_jax(sd, f"{prefix}.{name}")
    for name in ("linear1", "linear2"):
        out[name] = _linear_to_jax(sd, f"{prefix}.{name}")
    return out


_MODALITIES = ("visual", "audio")


def _trunk_to_jax(sd: Mapping, encoder: str) -> Dict:
    """The inverse of ``_trunk``; a one-modality model's unprefixed CLS
    tokens get the modality of its one embedder back."""
    p = {"time_mlp": _mlp_to_jax(sd, "time_mlp"),
         "time_norm": _norm_to_jax(sd, "time_mlp.6")}
    fe, tokens = {}, {}
    for key in sd:
        if not key.startswith("feature_encoding."):
            continue
        name = key[len("feature_encoding."):]
        if "." not in name:
            tokens[name] = _leaf(sd[key])
        elif name.endswith("_embedder.1.weight"):
            emb = name[:-len(".1.weight")]
            fe[emb] = {"proj": _linear_to_jax(sd, f"feature_encoding.{emb}.1"),
                       "norm": _norm_to_jax(sd, f"feature_encoding.{emb}.3")}
    embedders = [n for n in fe if n.endswith("_embedder")]
    cls = [n for n in tokens if n.endswith("_cls")]
    if len(embedders) == 1 and cls and not any(
            n.split("_", 1)[0] in _MODALITIES for n in cls):
        modality = embedders[0].split("_", 1)[0]
        tokens = {(f"{modality}_{n}" if n in cls else n): t
                  for n, t in tokens.items()}
    p["feature_encoding"] = {**fe, **tokens}
    p["encoder"] = {
        f"layer{i}": _encoder_layer_to_jax(sd, f"{encoder}.layers.{i}")
        for i in range(_indices(sd, encoder + ".layers.{}."))}
    p["drloc_mlp"] = _mlp_to_jax(sd, "drloc_mlp")
    pool = sorted({k.split(".")[1] for k in sd if k.startswith("pool.")})
    if pool:
        p["pool"] = {name: (_linear_to_jax(sd, f"pool.{name}")
                            if f"pool.{name}.bias" in sd else
                            {"kernel": _leaf(sd[f"pool.{name}.weight"].t())})
                     for name in pool}
    return p


def _heads_to_jax(sd: Mapping) -> Dict:
    names = {v: k for k, v in _CLS_HEADS.items()}
    return {names[port]: _linear_to_jax(sd, f"cls_head.{port}")
            for port in names if f"cls_head.{port}.weight" in sd}


def detection_params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict:
    """A port ``TimDetection`` state dict -> the flax ``TimDetection``
    param tree (the inverse of ``detection_state_dict_from_jax``)."""
    p = _trunk_to_jax(sd, "backbone")
    p["cls_head"] = _heads_to_jax(sd)
    reg = {v: k for k, v in _REG_HEADS.items()}
    p["reg_head"] = {reg[port]: _mlp_to_jax(sd, f"reg_head.{port}")
                     for port in reg if f"reg_head.{port}.0.weight" in sd}
    return p


def recognition_params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict:
    """A port ``TimRecognition`` state dict -> the flax ``TimRecognition``
    param tree (the inverse of ``recognition_state_dict_from_jax``)."""
    p = _trunk_to_jax(sd, "transformer_encoder")
    p["cls_head"] = _heads_to_jax(sd)
    return p


def _conv_to_jax(sd: Mapping, prefix: str) -> Dict:
    # torch [out, in, t, h, w] -> flax [t, h, w, in, out]
    return {"kernel": _leaf(sd[f"{prefix}.weight"].permute(2, 3, 4, 1, 0)),
            "bias": _leaf(sd[f"{prefix}.bias"])}


def _vit_block_to_jax(sd: Mapping, src: str) -> Dict:
    out = {"norm1": _norm_to_jax(sd, f"{src}.norm1"),
           "norm2": _norm_to_jax(sd, f"{src}.norm2"),
           "attn": {"qkv_kernel": _leaf(sd[f"{src}.attn.qkv.weight"].t()),
                    "q_bias": _leaf(sd[f"{src}.attn.q_bias"]),
                    "v_bias": _leaf(sd[f"{src}.attn.v_bias"]),
                    "proj": _linear_to_jax(sd, f"{src}.attn.proj")},
           "fc1": _linear_to_jax(sd, f"{src}.mlp.fc1"),
           "fc2": _linear_to_jax(sd, f"{src}.mlp.fc2")}
    if f"{src}.gamma_1" in sd:
        out["gamma_1"] = _leaf(sd[f"{src}.gamma_1"])
        out["gamma_2"] = _leaf(sd[f"{src}.gamma_2"])
    return out


def vit_params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict:
    """A port ``VideoMAEViT`` state dict -> the flax ``VideoMAEViT`` param
    tree (the inverse of ``vit_state_dict_from_jax``)."""
    p = {"patch_embed": _conv_to_jax(sd, "patch_embed.proj"),
         "fc_norm": _norm_to_jax(sd, "fc_norm")}
    for i in range(_indices(sd, "blocks.{}.")):
        p[f"block{i}"] = _vit_block_to_jax(sd, f"blocks.{i}")
    return p


def mae_params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict:
    """A port ``PretrainVideoMAE`` state dict -> the flax
    ``PretrainVideoMAE`` param tree (the inverse of
    ``mae_state_dict_from_jax``)."""
    p = {"patch_embed": _conv_to_jax(sd, "patch_embed.proj"),
         "encoder_norm": _norm_to_jax(sd, "encoder_norm"),
         "encoder_to_decoder": {
             "kernel": _leaf(sd["encoder_to_decoder.weight"].t())},
         "mask_token": _leaf(sd["mask_token"]),
         "decoder_norm": _norm_to_jax(sd, "decoder_norm"),
         "decoder_head": _linear_to_jax(sd, "decoder_head")}
    for i in range(_indices(sd, "blocks.{}.")):
        p[f"block{i}"] = _vit_block_to_jax(sd, f"blocks.{i}")
    for i in range(_indices(sd, "decoder_blocks.{}.")):
        p[f"decoder_block{i}"] = _vit_block_to_jax(sd, f"decoder_blocks.{i}")
    return p
