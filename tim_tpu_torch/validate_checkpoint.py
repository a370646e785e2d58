"""One-command released-checkpoint gate: counterpart of
``tim_tpu/validate_checkpoint.py``.

    python -m tim_tpu_torch.validate_checkpoint /path/ckpt.pth.tar \\
        --task recognition|detection [--nhead 8] [--num_feats 25]

Stages, each printing the JAX gate's ``[validate] <stage> PASS|FAIL|SKIP``
line (with the device it ran on and its seconds), exit code 1 on any
FAIL:

  1 load      ``torch.load`` (it unpickles the whole file: load only
              checkpoints you trust), unwrap ``{"state_dict": ...}`` and a
              uniform ``module.`` / ``_orig_mod.`` prefix
  2 infer     d_model, layers, input widths, class heads and modality read
              off the state dict's shapes (``infer_from_state_dict``, a copy
              of the JAX gate's)
  3 convert   a strict ``load_state_dict`` into the port's ``TimDetection``
              or ``TimRecognition`` at the inferred configuration, in fp32
              on the CPU (the port uses the reference's names, so nothing
              is converted); a missing, unexpected or misshapen tensor is a
              FAIL that names it
  4 parity    the reference's own ``models/tim.py``, executed in-process
              from the tree at ``REFERENCE_ROOT`` (``$TIM_REFERENCE_ROOT``,
              by default ``reference/`` beside the package), against the
              port, both in fp32 on the CPU: max |logit delta| <= 2e-4;
              SKIP when the tree is absent
  5 contract  int8 static + ``fast_scores`` against fp32 on the loaded
              weights, over synthetic feature banks, on ``device`` (the
              CUDA card unless ``main(..., device="cpu")``; raises without a
              card): score delta <= 0.1 max and 0.01 mean, top-1 agreement
              >= 0.98 where the fp32 top-2 margin exceeds 0.02. Detection:
              ``DetectionServer`` against ``DetectionServer.quantized``, its
              int8 class heads fused (kernel 3 on the card); recognition:
              ``TimRecognition`` against its quantized twin, calibrated on
              the same batch.

Two faults of the JAX gate are not copied: a head of fewer than 2 classes
(whose argmax always agrees) has agreement 1.0 instead of failing in
``np.partition``, and parity never runs anywhere but on the CPU (JAX keeps
whatever backend is already up).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import logging as _pylogging
import os
import sys
import time
import types
from typing import Dict, Optional

import numpy as np
import torch

from tim_tpu_torch.convert import _strip_wrapper

REFERENCE_ROOT = os.environ.get(
    "TIM_REFERENCE_ROOT",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "reference"))


class Gate:
    """The stage lines and their results: ``tags`` (PASS, FAIL or SKIP by
    stage), ``failed`` (stage names), ``numbers`` (per stage, what it
    measured) and ``seconds``."""

    def __init__(self):
        self.tags: Dict[str, str] = {}
        self.failed = []
        self.numbers: Dict[str, Dict] = {}
        self.seconds: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    def report(self, stage: str, ok: Optional[bool], detail: str = "",
               device: str = "cpu"):
        self.seconds[stage] = time.perf_counter() - self._t0
        tag = self.tags[stage] = ("SKIP" if ok is None
                                  else "PASS" if ok else "FAIL")
        print(f"[validate] {stage:<10} {tag}  {detail} ({device}, "
              f"{self.seconds[stage]:.2f} s)", flush=True)
        if ok is False:
            self.failed.append(stage)
        self._t0 = time.perf_counter()


def infer_from_state_dict(sd: Dict, task: str) -> Dict:
    """Architecture hyperparameters from checkpoint tensor shapes."""
    info: Dict = {"task": task}
    layer_prefix = ("backbone.layers." if task == "detection"
                    else "transformer_encoder.layers.")
    layers = {int(k[len(layer_prefix):].split(".")[0])
              for k in sd if k.startswith(layer_prefix)}
    if not layers:
        raise ValueError(
            f"no '{layer_prefix}*' keys — is --task {task} right for "
            "this file?")
    info["num_layers"] = max(layers) + 1
    # encoder width = 2 * d_model (concatenated feature+time encodings)
    width = sd[f"{layer_prefix}0.norm1.weight"].shape[0]
    info["d_model"] = width // 2

    mods = []
    for mod in ("visual", "audio"):
        k = f"feature_encoding.{mod}_embedder.1.weight"
        if k in sd:
            info[f"{mod}_input_dim"] = int(sd[k].shape[1])
            mods.append(mod)
    info["input_modality"] = ("audio_visual" if len(mods) == 2
                              else mods[0])

    def head(name):
        k = f"cls_head.{name}.weight"
        return int(sd[k].shape[0]) if k in sd else None

    verb, noun = head("fc_visual_verb"), head("fc_visual_noun")
    action, audio = head("fc_visual_action"), head("fc_audio_action")
    info["include_verb_noun"] = verb is not None
    if verb is not None:
        info["visual_classes"] = (verb, noun, action)
    elif action is not None:
        info["visual_classes"] = (action,)
    else:
        info["visual_classes"] = ()
    info["audio_classes"] = audio or 0
    info["pool_features"] = "pool.affine_audio.weight" in sd
    if task == "detection":
        info["has_visual_reg"] = "reg_head.fc_visual_action.0.weight" in sd
        info["has_audio_reg"] = "reg_head.fc_audio_action.0.weight" in sd
    return info


def build_config(info: Dict, nhead: int, num_feats: int,
                 compute_dtype: str = "float32"):
    from tim_tpu_torch.config import DetectionConfig, ModelConfig

    kw = dict(
        visual_classes=tuple(info["visual_classes"]),
        audio_classes=info["audio_classes"],
        input_modality=info["input_modality"],
        data_modality=info["input_modality"],
        visual_input_dim=info.get("visual_input_dim", 1),
        audio_input_dim=info.get("audio_input_dim", 1),
        d_model=info["d_model"], nhead=nhead,
        num_layers=info["num_layers"], num_feats=num_feats,
        compute_dtype=compute_dtype,
    )
    if info["task"] == "detection":
        return DetectionConfig(**kw)
    return ModelConfig(**kw, include_verb_noun=info["include_verb_noun"])


def _synthetic_batch(cfg, rng, batch=2, nq=3):
    """(v, a, times) float32 numpy arrays, drawn as the JAX gate draws
    them: the times of the context tokens and of the queries together."""
    f = cfg.num_feats
    v = a = None
    n_times = 0
    if "visual" in cfg.input_modality:
        v = rng.normal(size=(batch, f, cfg.visual_input_dim)).astype(
            np.float32)
        n_times += f + nq
    if "audio" in cfg.input_modality:
        a = rng.normal(size=(batch, f, cfg.audio_input_dim)).astype(
            np.float32)
        n_times += f + nq
    times = rng.uniform(size=(batch, n_times, 2)).astype(np.float32)
    return v, a, times


def _tensor(x, device="cpu"):
    return None if x is None else torch.as_tensor(x, device=device)


def stage_convert(gate, cfg, sd, info):
    """The port's model on the CPU in fp32 with ``sd`` loaded strictly, or
    None after a FAIL naming what did not fit."""
    from tim_tpu_torch.models import TimDetection, TimRecognition
    cls = TimDetection if info["task"] == "detection" else TimRecognition
    model = cls(cfg, device="cpu")
    want = model.state_dict()
    missing = [k for k in want if k not in sd]
    extra = [k for k in sd if k not in want]
    bad = [f"{k} {tuple(sd[k].shape)}!={tuple(want[k].shape)}"
           for k in want if k in sd
           and tuple(sd[k].shape) != tuple(want[k].shape)]
    ok = not (missing or bad or extra)
    gate.report("convert", ok,
                f"{len(want)} tensors"
                + (f"; missing {missing[:3]}" if missing else "")
                + (f"; mismatched {bad[:3]}" if bad else "")
                + (f"; unexpected {extra[:3]}" if extra else ""))
    if not ok:
        return None
    model.load_state_dict(sd, strict=True)
    return model


@contextlib.contextmanager
def reference_tim_module(variant: str):
    """Yield the executed reference ``models/tim.py`` of ``variant`` in
    {"recognition", "detection"} from ``REFERENCE_ROOT/<variant>``, its
    logging util stubbed; ``sys.modules`` is isolated, since both
    variants ship a package named ``time_interval_machine``."""
    ref_root = os.path.join(REFERENCE_ROOT, variant)
    saved = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] == "time_interval_machine"}
    for k in saved:
        del sys.modules[k]

    pkg = types.ModuleType("time_interval_machine")
    pkg.__path__ = [os.path.join(ref_root, "time_interval_machine")]
    utils_pkg = types.ModuleType("time_interval_machine.utils")
    utils_pkg.__path__ = [
        os.path.join(ref_root, "time_interval_machine/utils")]
    log_stub = types.ModuleType("time_interval_machine.utils.logging")
    log_stub.get_logger = lambda name: _pylogging.getLogger(name)
    sys.modules.update({
        "time_interval_machine": pkg,
        "time_interval_machine.utils": utils_pkg,
        "time_interval_machine.utils.logging": log_stub,
    })
    try:
        yield importlib.import_module("time_interval_machine.models.tim")
    finally:
        for k in list(sys.modules):
            if k.split(".")[0] == "time_interval_machine":
                del sys.modules[k]
        sys.modules.update(saved)


def stage_reference_parity(gate, sd, info, cfg, model, nhead):
    """The reference against ``model`` (the port's, fp32 on the CPU) on a
    synthetic batch, both on the CPU."""
    if not os.path.isdir(os.path.join(REFERENCE_ROOT, info["task"])):
        gate.report("parity", None, f"reference tree not found at "
                    f"{REFERENCE_ROOT} (set TIM_REFERENCE_ROOT)")
        return

    rng = np.random.default_rng(1)
    nq = 3
    f = cfg.num_feats
    v, a, times = _synthetic_batch(cfg, rng, batch=2, nq=nq)
    tv, ta, t_times = _tensor(v), _tensor(a), _tensor(times)
    nv = nq if "visual" in cfg.input_modality else 0
    na = nq if "audio" in cfg.input_modality else 0

    try:
        with reference_tim_module(info["task"]) as ref:
            if info["task"] == "recognition":
                rmodel = ref.TIM(
                    (list(info["visual_classes"]), info["audio_classes"]),
                    visual_input_dim=info.get("visual_input_dim", 1),
                    audio_input_dim=info.get("audio_input_dim", 1),
                    d_model=info["d_model"], nhead=nhead,
                    num_layers=info["num_layers"],
                    input_modality=info["input_modality"],
                    data_modality=info["input_modality"],
                    num_feats=f,
                    include_verb_noun=info["include_verb_noun"],
                    pool_features=info["pool_features"])
            else:
                rmodel = ref.TIM(
                    (info["visual_classes"][0] if info["visual_classes"]
                     else 1, info["audio_classes"]),
                    visual_input_dim=info.get("visual_input_dim", 1),
                    audio_input_dim=info.get("audio_input_dim", 1),
                    d_model=info["d_model"], nhead=nhead,
                    num_layers=info["num_layers"],
                    input_modality=info["input_modality"],
                    data_modality=info["input_modality"],
                    num_feats=f, include_verb_noun=False)
            rmodel.load_state_dict(sd, strict=True)
            rmodel.eval()
            with torch.no_grad():
                if info["task"] == "recognition":
                    te = rmodel(t_times, "time_mlp")
                    ref_logits, _ = rmodel([tv, ta], "encoder",
                                           time_encodings=te,
                                           num_v_queries=nv,
                                           num_a_queries=na)
                    ref_logits = [x for x in ref_logits if x is not None]
                else:
                    # forward_inference uses the model's own 0.01-pyramid
                    # queries (tim.py:339-400); feed the same intervals to
                    # the port
                    n_ft = f * (2 if info["input_modality"]
                                == "audio_visual" else 1)
                    ftimes = t_times[:, :n_ft]
                    (ref_cls, ref_reg, _), _, _, queries, _ = rmodel(
                        [tv, ta], "encoder", feature_times=ftimes,
                        target=None, label_queries=False)
                    nq_ref = rmodel.num_queries
                    parts = [ftimes]
                    for q_t in queries:
                        if q_t is not None:
                            parts.append(q_t.reshape(
                                len(t_times), nq_ref, 2))
                    t_times = torch.cat(parts, dim=1)
                    nv = nq_ref if tv is not None else 0
                    na = nq_ref if ta is not None else 0
                    ref_logits = ([x for x in ref_cls[2:] if x is not None]
                                  + [x for x in ref_reg if x is not None
                                     and x.numel()])
    except Exception as e:
        gate.report("parity", False,
                    f"reference execution failed: {type(e).__name__}: "
                    f"{str(e)[:200]}")
        return

    # the port gets the same per-stage FAIL treatment as the reference: a
    # shape mismatch must print "parity FAIL", not crash the gate
    try:
        with torch.inference_mode():
            if info["task"] == "recognition":
                out, _ = model(tv, ta, t_times, nv, na)
                logits = [x for x in out if x is not None]
            else:
                p_cls, p_reg, _ = model.encoder_forward(
                    tv, ta, model.encode_times(t_times), nv, na)
                logits = ([x for x in p_cls[2:] if x is not None]
                          + [x for x in p_reg if x is not None
                             and x.numel()])
        worst = 0.0
        for got, want in zip(logits, ref_logits):
            d = (got.double().reshape(want.shape) - want.double()).abs().max()
            worst = max(worst, float(d))
    except Exception as e:
        gate.report("parity", False,
                    f"port comparison failed: {type(e).__name__}: "
                    f"{str(e)[:200]}")
        return
    ok = worst <= 2e-4 and len(logits) == len(ref_logits)
    gate.numbers["parity"] = {"max_logit_diff": worst, "heads": len(logits)}
    gate.report("parity", ok, f"max |logit d| {worst:.2e} over "
                f"{len(logits)} heads (tol 2e-4)")


def _detection_contract(cfg, sd, rng, device):
    from tim_tpu_torch.serve import DetectionServer

    fcfg = dataclasses.replace(cfg, fast_scores=True,
                               quant_pallas_heads=True)
    f_srv = DetectionServer(cfg, sd, device=device, batch_size=8)
    q_srv = DetectionServer.quantized(fcfg, sd, [None], device=device,
                                      batch_size=8)
    nfeat, dur = 40, 12.0
    starts_t = np.linspace(0, dur - 1.1, nfeat).astype(np.float32)
    feat_times = np.stack([starts_t, starts_t + 1.1], -1)
    w_starts = f_srv._window_starts(dur)[:8]
    if len(w_starts) < 8:
        w_starts = np.concatenate(
            [w_starts, np.repeat(w_starts[-1:], 8 - len(w_starts))])
    batch = {}
    times_parts = []
    for key, modality, dim in (("v_feats", "visual", cfg.visual_input_dim),
                               ("a_feats", "audio", cfg.audio_input_dim)):
        if modality in cfg.input_modality:
            bank = rng.normal(size=(nfeat, dim)).astype(np.float32)
            feats, times = f_srv._assemble(bank, feat_times, w_starts, dur)
            batch[key] = _tensor(feats, device)
            times_parts.append(times)
    batch["times"] = _tensor(np.concatenate(times_parts, axis=1), device)
    batch["window_start"] = _tensor(w_starts.astype(np.float32), device)
    batch["window_size"] = torch.full((8,), f_srv.window_size,
                                      dtype=torch.float32, device=device)
    fo, qo = f_srv._infer(batch), q_srv._infer(batch)
    pairs = []
    for key in ("v_scores", "a_scores"):
        if fo.get(key) is not None:
            sf = fo[key].float().cpu().numpy()
            sq = qo[key].float().cpu().numpy()
            pairs.append((sf.reshape(-1, sf.shape[-1]),
                          sq.reshape(-1, sq.shape[-1])))
    return pairs


def _recognition_contract(cfg, sd, rng, device):
    from tim_tpu_torch.models import TimRecognition
    from tim_tpu_torch.ops import quant

    nq = 3
    v, a, times = (_tensor(x, device)
                   for x in _synthetic_batch(cfg, rng, batch=8, nq=nq))
    nv = nq if "visual" in cfg.input_modality else 0
    na = nq if "audio" in cfg.input_modality else 0
    qstate = quant.quantize_state_dict(sd)
    qcfg = dataclasses.replace(cfg, quantized_inference=True,
                               fast_scores=True)
    qmodel = TimRecognition(qcfg, device=device)
    qmodel.load_state_dict(qstate, strict=True)

    @torch.inference_mode()
    def calib_apply(_):
        qmodel(v, a, times, nv, na)

    scales = quant.calibrate_act_scales(qmodel.int8_layers(), calib_apply,
                                        [None])
    scfg = dataclasses.replace(qcfg, quant_static_acts=True,
                               quant_act_scales=scales)
    fmodel = TimRecognition(cfg, device=device)
    fmodel.load_state_dict(sd, strict=True)
    smodel = TimRecognition(scfg, device=device)
    smodel.load_state_dict(qstate, strict=True)
    with torch.inference_mode():
        f_out, _ = fmodel(v, a, times, nv, na)
        q_out, _ = smodel(v, a, times, nv, na)
    pairs = []
    for fl, ql in zip(f_out, q_out):
        if fl is None:
            continue
        fl = fl.float().cpu().numpy().reshape(-1, fl.shape[-1])
        ql = ql.float().cpu().numpy().reshape(-1, ql.shape[-1])
        pairs.append((_softmax(fl), _softmax(ql)))
    return pairs


def stage_contract(gate, info, cfg, sd, device):
    """The int8 static + ``fast_scores`` path against fp32 on the loaded
    weights, over synthetic feature banks, on ``device``: dense
    sigmoid/softmax score deltas and top-1 agreement."""
    rng = np.random.default_rng(2)
    contract = (_detection_contract if info["task"] == "detection"
                else _recognition_contract)
    try:
        pairs = contract(cfg, sd, rng, device)
        d = np.concatenate([np.abs(sf - sq).reshape(-1) for sf, sq in pairs])
        worst_max, worst_mean = float(d.max()), float(d.mean())
        agree_min = float(min(_margin_agreement(sf, sq)
                              for sf, sq in pairs))
    except Exception as e:
        gate.report("contract", False, f"quantized path failed: "
                    f"{type(e).__name__}: {str(e)[:200]}", str(device))
        return
    ok = worst_max <= 0.1 and worst_mean <= 0.01 and agree_min >= 0.98
    gate.numbers["contract"] = {"max": worst_max, "mean": worst_mean,
                                "agreement": agree_min}
    gate.report("contract", ok,
                f"int8+fast_scores score d max {worst_max:.3f} (<=0.1) "
                f"mean {worst_mean:.4f} (<=0.01), top-1 agree "
                f"{agree_min:.3f} (>=0.98)", str(device))


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _margin_agreement(sf: np.ndarray, sq: np.ndarray,
                      margin: float = 0.02) -> float:
    """Top-1 agreement where disagreements among near-ties don't count: a
    flipped argmax is only a real disagreement when the fp32 top-2 score
    margin exceeds ``margin``. A head of fewer than 2 classes has one
    argmax, which always agrees."""
    if sf.shape[-1] < 2:
        return 1.0
    same = sf.argmax(-1) == sq.argmax(-1)
    top2 = np.partition(sf, -2, axis=-1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > margin
    return float((same | ~decisive).mean())


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Validate a released reference checkpoint end-to-end "
                    "(PyTorch port)")
    ap.add_argument("checkpoint")
    ap.add_argument("--task", choices=("recognition", "detection"),
                    required=True)
    ap.add_argument("--nhead", type=int, default=8,
                    help="attention heads (not stored in the weights; "
                    "the released models use the parser default 8)")
    ap.add_argument("--num_feats", type=int, default=25,
                    help="feature timesteps per window (parser default)")
    ap.add_argument("--skip_parity", action="store_true")
    ap.add_argument("--skip_contract", action="store_true")
    return ap


def validate(argv=None, *, device=None) -> Gate:
    """Run the five stages on the checkpoint ``argv`` names and return the
    ``Gate`` (its ``failed`` stages, ``numbers`` and ``seconds``).
    ``device``: where the contract runs (the card by default; raises
    without one); load, infer, convert and parity run on the CPU."""
    from tim_tpu_torch.models.tim import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    gate = Gate()

    # -- 1 load ------------------------------------------------------
    try:
        ckpt = torch.load(args.checkpoint, map_location="cpu",
                          weights_only=False)
        sd = ckpt.get("state_dict", ckpt)
        sd = {k: torch.as_tensor(np.asarray(t)) if not torch.is_tensor(t)
              else t.detach().cpu() for k, t in sd.items()}
        gate.report("load", True, f"{len(sd)} tensors"
                    + (f", epoch {ckpt.get('epoch')}"
                       if isinstance(ckpt, dict) and "epoch" in ckpt
                       else ""))
    except Exception as e:
        gate.report("load", False, f"{type(e).__name__}: {e}")
        return gate

    # -- 2 infer -----------------------------------------------------
    try:
        sd = dict(_strip_wrapper(sd))
        info = infer_from_state_dict(sd, args.task)
        gate.numbers["infer"] = info
        gate.report("infer", True, str({k: v for k, v in info.items()
                                        if k != "task"}))
    except Exception as e:
        gate.report("infer", False, f"{type(e).__name__}: {e}")
        return gate

    cfg = build_config(info, args.nhead, args.num_feats)

    # -- 3 convert: a strict load --------------------------------------
    try:
        model = stage_convert(gate, cfg, sd, info)
    except Exception as e:
        gate.report("convert", False, f"{type(e).__name__}: {e}")
        return gate
    if model is None:
        return gate

    # -- 4 parity (CPU) -------------------------------------------------
    if args.skip_parity:
        gate.report("parity", None, "--skip_parity")
    else:
        stage_reference_parity(gate, sd, info, cfg, model, args.nhead)
    del model

    # -- 5 contract (device) --------------------------------------------
    if args.skip_contract:
        gate.report("contract", None, "--skip_contract", str(device))
    else:
        stage_contract(gate, info, cfg, sd, device)
    return gate


def main(argv=None, *, device=None) -> int:
    gate = validate(argv, device=device)
    if gate.failed:
        print(f"[validate] RESULT: FAIL ({', '.join(gate.failed)})",
              flush=True)
        return 1
    print("[validate] RESULT: PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
