"""Serving API over pre-extracted features: counterpart of
``tim_tpu/serve.py``'s ``RecognitionServer`` and ``DetectionServer``.

``RecognitionServer.classify_intervals`` classifies given [start, end]
intervals of an untrimmed video, each from up to ``ensemble`` windows that
hold it (logits averaged, then softmaxed):

    server = RecognitionServer(cfg, state_dict)        # on the CUDA card
    scores = server.classify_intervals(v_feats, a_feats, feat_times, ivals)

``DetectionServer.detect_video`` is untrimmed-video action detection in
one call.

Given per-timestep feature banks for one video, slide fixed windows, score
the dense query pyramid on the device in fixed-size batches, then threshold
and run per-video Soft-NMS on the host (``evals``, the port's copy of the
JAX package's code and native kernel):

    server = DetectionServer(cfg, state_dict)          # on the CUDA card
    detections = server.detect_video(v_feats, a_feats, feat_times, duration)

``DetectionServer.quantized`` builds the int8 static serving mode.

Raw media in, detections out: ``detect_video_frames`` (the unique frames
of a video, one clip table per visual backbone, spectrograms; the frame
bank deduplicated on the card, ``extract/dense_media.py``) and
``detect_video_media`` (a preprocessed clip per timestep through given
extractors) run the backbones and then ``detect_video``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from tim_tpu_torch.config import DetectionConfig, ModelConfig
from tim_tpu_torch.data.windows import window_feat_indices
from tim_tpu_torch.evals.format_predictions import (
    nms_per_video, threshold_predictions, threshold_predictions_topk)
from tim_tpu_torch.models.queries import generate_query_pyramid
from tim_tpu_torch.models.tim import (
    TimDetection, TimRecognition, resolve_device)
from tim_tpu_torch.ops import quant
from tim_tpu_torch.train.detection import make_inference_step


class RecognitionServer:
    """Classify given intervals of an untrimmed video with window-vote
    ensembling: each interval is answered from up to ``ensemble`` windows
    that contain it, its logits averaged over them and softmaxed (the
    reference's inference meter as a serving call). Every window holds
    one query per head; the batch is fixed (the last one padded with its
    last job, whose rows do not vote)."""

    def __init__(
        self,
        cfg: ModelConfig,
        state_dict: Mapping[str, torch.Tensor],
        *,
        device: Optional[torch.device | str] = None,
        feat_stride: int = 3,
        feat_gap: float = 0.2,
        window_stride: float = 1.0,
        ensemble: int = 5,
        batch_size: int = 64,
    ):
        """``state_dict``: reference-layout recognition weights (a
        released checkpoint, or ``convert.recognition_state_dict_from_jax``;
        the quantized layout when ``cfg.quantized_inference``). ``device``:
        the CUDA card unless given (raises without one)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.feat_stride = feat_stride
        self.window_stride = window_stride
        self.window_size = cfg.num_feats * feat_gap * feat_stride
        self.ensemble = ensemble
        self.batch_size = batch_size
        self.model = TimRecognition(cfg, device=self.device)
        self.model.load_state_dict(state_dict, strict=True)
        self._nv = 1 if "visual" in cfg.data_modality else 0
        self._na = 1 if "audio" in cfg.data_modality else 0

    @classmethod
    def quantized(cls, cfg: ModelConfig,
                  state_dict: Mapping[str, torch.Tensor],
                  calibration_batches: Iterable, *,
                  device: Optional[torch.device | str] = None,
                  **kwargs) -> "RecognitionServer":
        """Static-int8 recognition serving: counterpart of the JAX
        ``RecognitionServer.quantized``. Quantizes the fp32 ``state_dict``
        (``ops.quant.quantize_state_dict``), runs ``calibration_batches``
        once through the dynamic-int8 model to record each int8 layer's
        input abs-max, and serves with those static scales.

        ``calibration_batches``: (v, a, times) tuples shaped like the
        forward's inputs (tensors or numpy arrays; v or a None for an
        absent modality), or None for a zero batch of one window with
        zero times, as the JAX package feeds it."""
        device = resolve_device(device)
        qcfg = dataclasses.replace(cfg, quantized_inference=True)
        qstate = quant.quantize_state_dict(state_dict)
        qmodel = TimRecognition(qcfg, device=device)
        qmodel.load_state_dict(qstate, strict=True)
        nv = 1 if "visual" in cfg.data_modality else 0
        na = 1 if "audio" in cfg.data_modality else 0

        def tensor(a):
            return (None if a is None else
                    torch.as_tensor(a, dtype=torch.float32, device=device))

        @torch.inference_mode()
        def run(batch):
            if batch is None:
                v = (torch.zeros((1, cfg.num_feats, cfg.visual_input_dim),
                                 device=device)
                     if "visual" in cfg.input_modality else None)
                a = (torch.zeros((1, cfg.num_feats, cfg.audio_input_dim),
                                 device=device)
                     if "audio" in cfg.input_modality else None)
                times = torch.zeros((1, cfg.num_context + nv + na, 2),
                                    device=device)
            else:
                v, a, times = (tensor(x) for x in batch)
            qmodel(v, a, times, nv, na)

        scales = quant.calibrate_act_scales(
            qmodel.int8_layers(), run, calibration_batches)
        scfg = dataclasses.replace(qcfg, quant_static_acts=True,
                                   quant_act_scales=scales)
        return cls(scfg, qstate, device=device, **kwargs)

    # a copy of tim_tpu/serve.py's (that module imports jax); tests pin it
    # to the original
    def _covering_windows(self, start: float, end: float) -> np.ndarray:
        """Up to ``ensemble`` window starts whose window contains (or best
        clips) the interval."""
        lo = max(0.0, end - self.window_size)
        lo = math.ceil(lo / self.window_stride) * self.window_stride
        hi = max(start, 0.0)
        starts = np.arange(lo, hi + 1e-6, self.window_stride)
        if len(starts) == 0:
            starts = np.asarray([max(0.0, start)])
        if len(starts) > self.ensemble:
            sel = np.linspace(0, len(starts) - 1, self.ensemble).astype(int)
            starts = starts[sel]
        return starts

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    def classify_intervals(
        self,
        v_feats: Optional[np.ndarray],      # [T, Dv]
        a_feats: Optional[np.ndarray],      # [T, Da]
        feat_times: np.ndarray,             # [T, >=2]
        intervals: np.ndarray,              # [N, 2] video-time
    ) -> Dict[str, np.ndarray]:
        """Returns the softmax scores [N, C] of each head (``verb``,
        ``noun``, ``action``, ``audio``, as the model has them)."""
        nf = self.cfg.num_feats
        jobs = [(float(ws), qi)
                for qi, (s, e) in enumerate(intervals)
                for ws in self._covering_windows(float(s), float(e))]
        n = len(intervals)
        sums: Dict[str, np.ndarray] = {}
        counts = np.zeros(n)

        for i in range(0, len(jobs), self.batch_size):
            chunk = jobs[i:i + self.batch_size]
            pad = self.batch_size - len(chunk)
            chunk_p = chunk + [chunk[-1]] * pad

            feats_v, feats_a, batch_times = [], [], []
            for ws, qi in chunk_p:
                idx = window_feat_indices(
                    feat_times, ws,
                    min(ws + self.window_size, feat_times[-1, 1]),
                    self.feat_stride, nf)
                t_parts = []
                if v_feats is not None:
                    feats_v.append(v_feats[idx])
                    t_parts.append(feat_times[idx, :2])
                if a_feats is not None:
                    feats_a.append(a_feats[idx])
                    t_parts.append(feat_times[idx, :2])
                q = intervals[qi][None].astype(np.float32)
                t = np.concatenate(
                    t_parts + [q] * (self._nv + self._na), axis=0)
                batch_times.append(np.clip(
                    (t - ws) / self.window_size, 0.0, None))

            with torch.inference_mode():
                logits, _ = self.model(
                    self._to_device(np.stack(feats_v)) if feats_v else None,
                    self._to_device(np.stack(feats_a)) if feats_a else None,
                    self._to_device(np.stack(batch_times)), self._nv,
                    self._na)
            for name, lg in zip(("verb", "noun", "action", "audio"),
                                logits):
                if lg is None:
                    continue
                lg = lg[:, 0].float().cpu().numpy()          # [B, C]
                if name not in sums:
                    sums[name] = np.zeros((n, lg.shape[-1]))
                for row, (ws, qi) in enumerate(chunk):
                    sums[name][qi] += lg[row]
            for ws, qi in chunk:
                counts[qi] += 1

        out = {}
        denom = np.maximum(counts, 1.0)[:, None]
        for name, s in sums.items():
            mean = s / denom
            e = np.exp(mean - mean.max(-1, keepdims=True))
            out[name] = e / e.sum(-1, keepdims=True)
        return out


class DetectionServer:
    def __init__(
        self,
        cfg: DetectionConfig,
        state_dict: Mapping[str, torch.Tensor],
        *,
        device: Optional[torch.device | str] = None,
        feat_stride: int = 3,
        feat_gap: float = 0.2,
        window_stride: float = 1.0,
        batch_size: int = 128,
        top_k: Optional[int] = None,
    ):
        """``state_dict``: reference-layout detection weights (a released
        checkpoint, or ``convert.detection_state_dict_from_jax``; the
        quantized layout when ``cfg.quantized_inference``). ``device``: the
        CUDA card unless given (raises without one). ``top_k``: ship only
        the k best classes per query from the device (exact as long as
        every above-threshold class fits in k)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.feat_stride = feat_stride
        self.window_stride = window_stride
        self.window_size = cfg.num_feats * feat_gap * feat_stride
        self.batch_size = batch_size
        self.top_k = top_k
        self.model = TimDetection(cfg, device=self.device)
        self.model.load_state_dict(state_dict, strict=True)
        self._infer = make_inference_step(self.model, cfg, top_k=top_k)
        self.num_queries = generate_query_pyramid(
            cfg.inference_query_size).shape[0]

    @classmethod
    def quantized(cls, cfg: DetectionConfig,
                  state_dict: Mapping[str, torch.Tensor],
                  calibration_batches: Iterable[Optional[Mapping]], *,
                  device: Optional[torch.device | str] = None,
                  **kwargs) -> "DetectionServer":
        """Static-int8 serving: counterpart of the JAX
        ``DetectionServer.quantized``. Quantizes the fp32 ``state_dict``
        (``ops.quant.quantize_state_dict``), runs ``calibration_batches``
        once through the dynamic-int8 model to record each int8 layer's
        input abs-max, and serves with those static scales.

        ``calibration_batches``: batches as ``make_inference_step`` takes
        them (tensors or numpy arrays), or None for a zero batch of one
        window. They are fed as the JAX package feeds them: the full
        forward without ``shared_queries``, the query intervals all
        zeros (not the inference pyramid)."""
        device = resolve_device(device)
        qcfg = dataclasses.replace(cfg, quantized_inference=True)
        qstate = quant.quantize_state_dict(state_dict)
        qmodel = TimDetection(qcfg, device=device)
        qmodel.load_state_dict(qstate, strict=True)
        nq = generate_query_pyramid(cfg.inference_query_size).shape[0]
        nv = nq if "visual" in cfg.data_modality else 0
        na = nq if "audio" in cfg.data_modality else 0

        def tensor(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        def feats(batch, key, modality, dim):
            if batch is None:
                return (torch.zeros((1, cfg.num_feats, dim), device=device)
                        if modality in cfg.input_modality else None)
            return None if batch.get(key) is None else tensor(batch[key])

        @torch.inference_mode()
        def run(batch):
            v = feats(batch, "v_feats", "visual", cfg.visual_input_dim)
            a = feats(batch, "a_feats", "audio", cfg.audio_input_dim)
            b = (v if v is not None else a).shape[0]
            ctx = (torch.zeros((1, cfg.num_context, 2), device=device)
                   if batch is None else tensor(batch["times"]))
            times = torch.cat(
                [ctx, torch.zeros((b, nv + na, 2), device=device)], dim=1)
            qmodel.encoder_forward(v, a, qmodel.encode_times(times), nv, na)

        scales = quant.calibrate_act_scales(
            qmodel.int8_layers(), run, calibration_batches)
        scfg = dataclasses.replace(qcfg, quant_static_acts=True,
                                   quant_act_scales=scales)
        return cls(scfg, qstate, device=device, **kwargs)

    # ------------------------------------------------------------------
    # The two numpy helpers are copies of tim_tpu/serve.py's (that module
    # imports jax); tests pin them to the originals.
    def _window_starts(self, duration: float) -> np.ndarray:
        dur = math.ceil(duration)
        n = max(math.ceil((dur - self.window_size)
                          / self.window_stride) + 1, 1)
        # float32 like the dataset path (float64 starts shift times by
        # 1 ulp and flip score-threshold boundaries)
        return (self.window_stride * np.arange(n)).astype(np.float32)

    def _assemble(self, feats, feat_times, starts, duration: float):
        """Exact dataset semantics (``build_detection_windows`` +
        ``DetectionDataset.__getitem__``): window stop clipped to
        ceil(duration), times rounded to 3 decimals before normalizing."""
        nf = self.cfg.num_feats
        dur = math.ceil(duration)
        idx = np.stack([
            window_feat_indices(feat_times, s,
                                min(dur, s + self.window_size),
                                self.feat_stride, nf)
            for s in starts])
        data = feats[idx]                                  # [B, F, D]
        times = feat_times[idx][:, :, :2]
        times = np.clip(
            np.round(times - starts[:, None, None], 3)
            / self.window_size, 0.0, None)
        return data.astype(np.float32), times.astype(np.float32)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _extract(self, inputs: np.ndarray, extractor,
                 batch: int) -> np.ndarray:
        """[T, D] fp32 features of every timestep's input through
        ``extractor`` (batched, the last batch padded), its batches sent
        to ``extractor.device`` or, without one, to the server's device."""
        from tim_tpu_torch.extract.pipeline import extract_features_for_video

        if not hasattr(extractor, "device"):
            extractor = _Placed(extractor, self.device)
        return extract_features_for_video(
            lambda t, a: inputs[t], len(inputs), 1, extractor,
            batch_size=batch)[:, 0]

    # ------------------------------------------------------------------
    def detect_video_media(
        self,
        video_clips: Optional[np.ndarray],   # [T, ...] raw clip per step
        audio_specs: Optional[np.ndarray],   # [T, ...] spectrogram per step
        feat_times: np.ndarray,              # [T, >=2]
        duration: float,
        *,
        visual_extractor=None,               # [B, ...] -> [B, Dv]
        audio_extractor=None,                # [B, ...] -> [B, Da]
        extract_batch: int = 8,
        **detect_kwargs,
    ) -> Dict[str, np.ndarray]:
        """Raw-media serving: run the extractors over every feature
        timestep, then ``detect_video`` over the resulting banks (the
        reference's three offline programs as one call). Extractors are
        callables on batched tensors (e.g. ``extract.cli.make_visual_apply``
        / ``make_audio_apply``, a backbone, or a fused pipeline's
        ``extract_visual``); a batch goes to the extractor's ``device``
        attribute, else to the server's device. Each timestep's clip or
        spectrogram is already preprocessed."""
        v_feats = a_feats = None
        if video_clips is not None:
            if visual_extractor is None:
                raise ValueError("video clips given without a "
                                 "visual_extractor")
            v_feats = self._extract(video_clips, visual_extractor,
                                    extract_batch)
        if audio_specs is not None:
            if audio_extractor is None:
                raise ValueError("audio spectrograms given without an "
                                 "audio_extractor")
            a_feats = self._extract(audio_specs, audio_extractor,
                                    extract_batch)
        return self.detect_video(v_feats, a_feats, feat_times, duration,
                                 **detect_kwargs)

    # ------------------------------------------------------------------
    def detect_video_frames(
        self,
        frames: np.ndarray,                  # [Nf, H, W, 3] unique frames
        clip_frames,                         # [T, F] frame idx per timestep
        feat_times: np.ndarray,              # [T, >=2]
        duration: float,
        *,
        visual_model,                        # nn.Module or sequence
        audio_specs: Optional[np.ndarray] = None,
        audio_extractor=None,
        extract_batch: int = 8,
        mode: str = "auto",
        tubelet: int = 2,
        frame_transform=None,                # on the card, after gather
        **detect_kwargs,
    ) -> Dict[str, np.ndarray]:
        """Overlap-aware raw-media serving: ``detect_video_media`` without
        its redundant uploads and embeds. Each unique frame crosses to the
        card once, clips are gathered there, and with ``pair_embed`` each
        unique frame pair is patch-embedded once
        (``extract/dense_media.py``; exact). ``clip_frames`` holds 0-based
        row indices into ``frames``: rebase 1-based sampler output such as
        ``omnivore_frame_indices`` rows with ``table - 1``, one origin for
        every backbone. An empty table or an index out of range raises
        ``ValueError``.

        ``visual_model``: a backbone module (it owns its weights, so the
        JAX method's ``visual_variables`` is gone), or a sequence of them
        with one frame table each in ``clip_frames`` (the production EPIC
        features are Omnivore 1024 ‖ VideoMAE 1024 concatenated in list
        order, ``merge_features.py:80-83``). ``mode``: ``stream`` for
        ``auto`` (per-batch mini-banks whose uploads overlap the previous
        batch's compute), or ``gather``, ``pair_embed``, ``naive``.

        Ship ``frames`` as uint8 with
        ``frame_transform=dense_media.uint8_normalizer()`` to quarter the
        host -> card bytes against fp32; the normalization runs on the
        card after the gather. ``audio_specs`` go through
        ``audio_extractor`` as in ``detect_video_media``; the rest of the
        keywords go to ``detect_video``."""
        from tim_tpu_torch.extract.dense_media import (
            build_clip_plan, extract_dense_visual)

        models = (list(visual_model)
                  if isinstance(visual_model, (list, tuple))
                  else [visual_model])
        tables = (list(clip_frames)
                  if isinstance(clip_frames, (list, tuple))
                  else [clip_frames] * len(models))
        if len(models) != len(tables):
            raise ValueError(f"visual_model/clip_frames lengths differ: "
                             f"{len(models)}/{len(tables)}")

        parts = []
        for m, table in zip(models, tables):
            table = np.asarray(table)
            if table.size == 0:
                raise ValueError(f"clip_frames table of shape {table.shape} "
                                 f"is empty: one row of frame indices per "
                                 f"feature timestep is needed")
            if table.min() < 0 or table.max() >= len(frames):
                raise ValueError(
                    f"clip_frames must be 0-based indices into frames "
                    f"[0, {len(frames)}); got range "
                    f"[{table.min()}, {table.max()}] — rebase 1-based "
                    f"sampler rows with `table - 1` (one shared origin "
                    f"for all backbones)")
            plan = build_clip_plan(table, tubelet=tubelet)
            rows = plan.unique_frames
            # skip the fancy-index host copy when the table already
            # touches every frame
            bank = (frames if len(rows) == len(frames)
                    and np.array_equal(rows, np.arange(len(frames)))
                    else frames[rows])
            parts.append(extract_dense_visual(
                m, bank, plan, batch_size=extract_batch,
                mode="stream" if mode == "auto" else mode,
                frame_transform=frame_transform).float().numpy())
        if len({len(p) for p in parts}) > 1:
            raise ValueError(
                f"backbone frame tables produced different timestep "
                f"counts: {[len(p) for p in parts]}")
        v_feats = (parts[0] if len(parts) == 1
                   else np.concatenate(parts, axis=-1))
        a_feats = None
        if audio_specs is not None:
            if audio_extractor is None:
                raise ValueError("audio spectrograms given without an "
                                 "audio_extractor")
            a_feats = self._extract(audio_specs, audio_extractor,
                                    extract_batch)
        return self.detect_video(v_feats, a_feats, feat_times, duration,
                                 **detect_kwargs)

    # ------------------------------------------------------------------
    def detect_video(
        self,
        v_feats: Optional[np.ndarray],      # [T, Dv]
        a_feats: Optional[np.ndarray],      # [T, Da]
        feat_times: np.ndarray,             # [T, >=2]
        duration: float,
        *,
        score_threshold: float = 0.03,
        nms_sigma: float = 0.25,
        nms_iou: float = 0.1,
        modality: str = "visual",           # which score head to report
    ) -> Dict[str, np.ndarray]:
        """Returns {"segments" [N, 2] video-time, "scores" [N],
        "labels" [N]} after Soft-NMS."""
        starts = self._window_starts(duration)
        bs = self.batch_size
        base = "v" if modality == "visual" else "a"

        all_scores, all_props = [], []
        for i in range(0, len(starts), bs):
            chunk = starts[i:i + bs]
            pad = bs - len(chunk)
            chunk_p = np.concatenate(
                [chunk, np.repeat(chunk[-1:], pad)]) if pad else chunk

            times_parts = []
            batch = {}
            for key, feats in (("v_feats", v_feats), ("a_feats", a_feats)):
                if feats is None:
                    continue
                data, t = self._assemble(feats, feat_times, chunk_p,
                                         duration)
                batch[key] = self._to_device(data)
                times_parts.append(t)
            batch["times"] = self._to_device(
                np.concatenate(times_parts, axis=1))
            batch["window_start"] = self._to_device(
                chunk_p.astype(np.float32))
            batch["window_size"] = torch.full(
                (len(chunk_p),), self.window_size, dtype=torch.float32,
                device=self.device)

            out = self._infer(batch)
            take = len(chunk)
            if self.top_k is None:
                all_scores.append(out[f"{base}_scores"][:take].cpu().numpy())
            else:
                all_scores.append(
                    (out[f"{base}_topk_values"][:take].cpu().numpy(),
                     out[f"{base}_topk_classes"][:take].cpu().numpy()))
            all_props.append(out[f"{base}_proposals"][:take].cpu().numpy())

        props = np.concatenate(all_props).reshape(-1, 2)
        vids = np.asarray(["__video__"] * len(props), object)
        if self.top_k is None:
            scores = np.concatenate(all_scores).reshape(
                -1, all_scores[0].shape[-1])
            cands = threshold_predictions(vids, props, scores,
                                          score_threshold)
        else:
            vals = np.concatenate([v for v, _ in all_scores]).reshape(
                -1, all_scores[0][0].shape[-1])
            classes = np.concatenate([c for _, c in all_scores]).reshape(
                -1, all_scores[0][1].shape[-1])
            cands = threshold_predictions_topk(
                vids, props, vals, classes,
                score_threshold=score_threshold)
        dets = nms_per_video(cands, iou_threshold=nms_iou, sigma=nms_sigma)
        if "__video__" not in dets:
            return {"segments": np.zeros((0, 2), np.float32),
                    "scores": np.zeros(0, np.float32),
                    "labels": np.zeros(0, np.int64)}
        d = dets["__video__"]
        return {"segments": d["segments"], "scores": d["scores"],
                "labels": d["labels"]}


class _Placed:
    """An extractor without a ``device`` attribute, given one: where
    ``extract_features_for_video`` sends its batches."""

    def __init__(self, fn, device: torch.device):
        self.fn, self.device = fn, device

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)
