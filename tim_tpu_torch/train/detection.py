"""Dense detection inference: counterpart of
``tim_tpu/train/detection.py::make_inference_step``."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from tim_tpu_torch.config import DetectionConfig
from tim_tpu_torch.models.queries import generate_query_pyramid
from tim_tpu_torch.models.tim import TimDetection


def make_inference_step(model: TimDetection, cfg: DetectionConfig,
                        top_k: Optional[int] = None):
    """Returns ``infer_step(batch) -> dict`` with per-query sigmoid scores
    and proposals denormalised to video time (``clamp(reg) * win_size +
    win_start``), the dense extraction dump.

    ``batch``: tensors on the model's device -- ``times`` [B, num_ctx, 2],
    ``v_feats``/``a_feats`` [B, F, D] per input modality, ``window_start``
    and ``window_size`` [B].

    ``top_k``: emit only the k best classes per query as
    ``<head>_topk_values`` / ``<head>_topk_classes`` instead of the dense
    [B, Nq, C] score matrices."""
    device = next(model.parameters()).device
    grid = torch.from_numpy(
        generate_query_pyramid(cfg.inference_query_size)).to(device)
    nq = grid.shape[0]
    has_visual = "visual" in cfg.data_modality
    has_audio = "audio" in cfg.data_modality
    nv = nq if has_visual else 0
    na = nq if has_audio else 0

    @torch.inference_mode()
    def infer_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch_size = batch["times"].shape[0]
        # The query grid is identical for every window: encode its time
        # intervals once and broadcast.
        te_feat = model.encode_times(batch["times"])
        te_query = model.encode_times(grid[None]).expand(batch_size, -1, -1)
        te = torch.cat([te_feat] + [te_query] * (has_visual + has_audio),
                       dim=1)
        cls_logits, reg_preds, _ = model.encoder_forward(
            batch.get("v_feats"), batch.get("a_feats"), te, nv, na,
            shared_queries=True)

        win_start = batch["window_start"][:, None, None]
        win_size = batch["window_size"][:, None, None]

        def scores_out(out, name, logits):
            probs = torch.sigmoid(logits.float())
            if top_k is None:
                out[name] = probs
                return
            vals, idx = torch.topk(probs, min(top_k, probs.shape[-1]), dim=-1)
            base = name.split("_")[0]
            out[f"{base}_topk_values"] = vals
            out[f"{base}_topk_classes"] = idx.to(torch.int32)

        out = {"queries": grid[None] * win_size + win_start}
        if has_visual:
            scores_out(out, "v_scores", cls_logits[2])
            if len(cfg.visual_classes) == 3:
                scores_out(out, "verb_scores", cls_logits[0])
                scores_out(out, "noun_scores", cls_logits[1])
            out["v_proposals"] = (reg_preds[0].float().clamp(0.0, 1.0)
                                  * win_size + win_start)
        if has_audio:
            scores_out(out, "a_scores", cls_logits[3])
            out["a_proposals"] = (reg_preds[1].float().clamp(0.0, 1.0)
                                  * win_size + win_start)
        return out

    return infer_step
