"""VisualBERT two-stage extraction: region features -> fused encoder.

Rebuild of the reference's feature_extraction/extract_visualbert_features.py:
stage 1 runs a Mask-RCNN detector and selects 10-100 region boxes per image
by per-class NMS + max-confidence ranking (:127-168), caching their 1024-d
box-head features; stage 2 feeds caption tokens + the cached visual embeds
through VisualBERT and pools fused mean/CLS features (:223-264).

detectron2 is not available in this environment, so stage 1 is split into
(a) the box-selection semantics — pure numpy, fully tested here — and (b) a
pluggable ``detector`` callable that supplies raw per-image detector outputs
(class probabilities, per-class boxes, box-head features).  Any Mask-RCNN
implementation (detectron2, torchvision) slots in on a host that has one;
the selection, caching and stage-2 pooling are framework code.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable

import numpy as np

from multimodal_decoding_tpu_torch.config import FUSED_CLS_FEAT_KEY, FUSED_MEAN_FEAT_KEY

MIN_BOXES = 10  # extract_visualbert_features.py:32-33
MAX_BOXES = 100
SCORE_THRESH = 0.5  # cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST (:44)
NMS_THRESH = 0.5  # detectron2 ROI_HEADS.NMS_THRESH_TEST default (:146)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy IoU non-maximum suppression -> kept indices (score-descending).

    Same semantics as detectron2's ``nms`` consumed at :153.
    """
    boxes = np.asarray(boxes, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores)
    areas = (boxes[:, 2] - boxes[:, 0]).clip(0) * (boxes[:, 3] - boxes[:, 1]).clip(0)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = (xx2 - xx1).clip(0) * (yy2 - yy1).clip(0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-12)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, dtype=np.int64)


def max_confidences(
    cls_probs: np.ndarray, cls_boxes: np.ndarray, nms_threshold: float = NMS_THRESH
) -> np.ndarray:
    """Per-proposal max class confidence surviving per-class NMS.

    ``cls_probs`` [R, C+1] with column 0 treated as background (class-c boxes
    are scored by probability column c+1), ``cls_boxes`` [R, C, 4].  This
    off-by-one pairing is the REFERENCE'S OWN indexing (calc_max_confs
    :145-156 pairs cls_boxes[:, cls_ind] with cls_prob[:, cls_ind + 1] even
    though detectron2 puts background last) — reproduced faithfully because
    the cached region features of the published pipeline depend on it.  A
    pluggable detector must therefore supply probs in the layout this
    indexing expects.  For every foreground class, NMS the class's boxes by
    the class score; surviving proposals record the score if it beats their
    current maximum.
    """
    n_boxes, n_classes_plus_1 = cls_probs.shape
    max_conf = np.zeros(n_boxes)
    for cls in range(n_classes_plus_1 - 1):
        scores = cls_probs[:, cls + 1]
        keep = nms(cls_boxes[:, cls, :], scores, nms_threshold)
        max_conf[keep] = np.maximum(max_conf[keep], scores[keep])
    return max_conf


def select_boxes(
    max_conf: np.ndarray,
    score_threshold: float = SCORE_THRESH,
    min_boxes: int = MIN_BOXES,
    max_boxes: int = MAX_BOXES,
) -> np.ndarray:
    """Indices of regions to keep: above-threshold, padded/truncated to
    [min_boxes, max_boxes] by confidence rank (filter_boxes :158-163)."""
    keep = np.where(max_conf >= score_threshold)[0]
    if len(keep) < min_boxes:
        keep = np.argsort(-max_conf)[:min_boxes]
    elif len(keep) > max_boxes:
        keep = np.argsort(-max_conf)[:max_boxes]
    return keep


def extract_region_features(
    ids,
    images,
    detector: Callable,
    cache_path: str | None = None,
    score_threshold: float = SCORE_THRESH,
    min_boxes: int = MIN_BOXES,
    max_boxes: int = MAX_BOXES,
) -> dict:
    """Stage 1: {stim_id: [n_kept, D] region features} with pickle caching.

    ``detector(image) -> (cls_probs [R, C+1], cls_boxes [R, C, 4],
    box_features [R, D])`` abstracts the Mask-RCNN forward
    (extract_image_features :170-221); selection/caching semantics live here.
    """
    if cache_path is not None and os.path.isfile(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)
    feats = {}
    for stim_id, image in zip(ids, images):
        cls_probs, cls_boxes, box_features = detector(image)
        max_conf = max_confidences(np.asarray(cls_probs), np.asarray(cls_boxes))
        keep = select_boxes(max_conf, score_threshold, min_boxes, max_boxes)
        feats[stim_id] = np.asarray(box_features)[keep]
    if cache_path is not None:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        with open(cache_path, "wb") as f:
            pickle.dump(feats, f, protocol=pickle.HIGHEST_PROTOCOL)
    return feats


def make_visualbert_extractor(model, tokenizer, region_features: dict) -> Callable:
    """Stage 2: VisualBERT over caption tokens + cached visual embeds, on the
    model's device.

    Pooling mirrors the reference exactly (:231-264): fused mean averages
    the padding-masked language tokens together with the visual tokens
    MINUS the first visual token (the reference skips img_embeddings[:, 0]);
    fused CLS is the pooler output.
    """
    import torch

    model.eval()
    device = next(model.parameters()).device

    def extract(ids, captions, images):
        inputs = {k: v.to(device) for k, v in
                  tokenizer(list(captions), padding=True, return_tensors="pt").items()}
        # select_boxes keeps anywhere in [min_boxes, max_boxes] regions per
        # image, so mixed-count batches are the norm: pad every image's
        # features to the batch max and mask the padding (the reference's
        # torch.stack would crash here — fixed, not replicated).
        region = [
            torch.as_tensor(region_features[i], dtype=torch.float32, device=device) for i in ids
        ]
        counts = torch.as_tensor([r.shape[0] for r in region], device=device)
        vmax = int(counts.max())
        visual_embeds = torch.stack(
            [torch.nn.functional.pad(r, (0, 0, 0, vmax - r.shape[0])) for r in region]
        )
        vis_mask = (
            torch.arange(vmax, device=device)[None, :] < counts[:, None]
        ).to(torch.long)
        with torch.no_grad():
            out = model(
                input_ids=inputs["input_ids"],
                attention_mask=inputs["attention_mask"],
                token_type_ids=inputs.get("token_type_ids"),
                visual_embeds=visual_embeds,
                visual_attention_mask=vis_mask,
                visual_token_type_ids=torch.ones_like(vis_mask),
            )
        h = out.last_hidden_state
        n_text = inputs["input_ids"].shape[1]
        lang, img = h[:, :n_text], h[:, n_text:]
        mask = inputs["attention_mask"].unsqueeze(-1).to(h.dtype)
        img_mask = vis_mask.unsqueeze(-1).to(h.dtype)
        fused_mean = (
            (lang * mask).sum(dim=1) + (img * img_mask)[:, 1:].sum(dim=1)
        ) / (mask.sum(dim=1) + (counts - 1).unsqueeze(-1).to(h.dtype))
        return {
            FUSED_MEAN_FEAT_KEY: fused_mean.float().cpu().numpy(),
            FUSED_CLS_FEAT_KEY: out.pooler_output.float().cpu().numpy(),
        }

    return extract
