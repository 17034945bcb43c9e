"""Feature-extraction harness: stimuli dataset + extractor loop + pickle schema.

Rebuild of the reference's feature_extraction/feat_extraction_utils.py without
the torch DataLoader dependency: plain-Python batching feeding a pure
``extract_fn(ids, captions, images) -> {feature_key: [B, D] array}`` —
implementable with torch forwards on the GPU (extractors.py, imagebind.py) or
classic filterbanks (gabor.py).  The output pickle schema
``{stim_id: {feature_key: float32 vector}}`` is the data-layer contract
(data.py:401-445 reads it).

Spans and counters (``utils/profiling``, on only under ``torch.profiler``):
``mdt.extract.load`` (a batch's image loads, run by the generator, so a
sibling of the batch), ``mdt.extract.batch`` (one loop iteration: the
extract_fn and the dict fill), ``mdt.extract.save`` (the pickle write);
counters ``mdt.extract.stimuli`` (a batch's stimuli) and
``mdt.extract.decoded_pixels`` (each loaded image's source width x height).
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Callable

import numpy as np

from multimodal_decoding_tpu_torch import config
from multimodal_decoding_tpu_torch.utils.profiling import count, span


@dataclass
class StimuliDataset:
    """COCO stimulus table (parity: CoCoDataset, feat_extraction_utils.py:13-67).

    Reads ``stimuli.csv`` (index=coco id; columns img_path, caption, used),
    keeps rows with used==True.
    """

    img_paths: dict
    captions: dict
    root: str

    @staticmethod
    def from_csv(stim_info_path: str | None = None, coco_root: str | None = None):
        import pandas as pd

        stim_info_path = stim_info_path or config.STIM_INFO_PATH
        coco_root = coco_root or config.COCO_IMAGES_DIR
        data = pd.read_csv(stim_info_path, index_col=0)
        data = data[data.used == True]  # noqa: E712
        return StimuliDataset(
            img_paths=data.img_path.to_dict(),
            captions=data.caption.to_dict(),
            root=coco_root,
        )

    @property
    def stimuli_ids(self):
        return list(self.img_paths.keys())

    def __len__(self):
        return len(self.img_paths)

    def load_image(self, coco_id):
        from PIL import Image

        return Image.open(os.path.join(self.root, self.img_paths[coco_id])).convert("RGB")

    def batches(self, batch_size: int, mode: str = "both"):
        """Yield (ids, captions, images) batches; images lazily PIL-loaded."""
        ids = self.stimuli_ids
        for start in range(0, len(ids), batch_size):
            chunk = ids[start : start + batch_size]
            caps = [self.captions[i] for i in chunk]
            if mode == "caption":
                yield chunk, caps, None
            else:
                with span("mdt.extract.load"):
                    imgs = [self.load_image(i) for i in chunk]
                    count("mdt.extract.decoded_pixels", sum(im.width * im.height for im in imgs))
                yield chunk, (caps if mode == "both" else None), imgs


def run_extraction(
    extract_fn: Callable,
    model_name: str,
    dataset: StimuliDataset | None = None,
    batch_size: int = 10,
    out_path: str | None = None,
    mode: str = "both",
    progress: bool = True,
) -> dict:
    """Extraction loop + pickle write (parity: FeatureExtractor.extract_features,
    feat_extraction_utils.py:90-105)."""
    dataset = dataset or StimuliDataset.from_csv()
    all_feats: dict = {}
    n_batches = (len(dataset) + batch_size - 1) // batch_size
    for b, (ids, captions, images) in enumerate(dataset.batches(batch_size, mode)):
        with span("mdt.extract.batch"):
            count("mdt.extract.stimuli", len(ids))
            feats_batch = extract_fn(ids, captions, images)
            for key, feats in feats_batch.items():
                feats = np.asarray(feats, dtype=np.float32)
                for i, stim_id in enumerate(ids):
                    all_feats.setdefault(int(stim_id), {})[key] = feats[i]
        if progress:
            print(f"extraction batch {b + 1}/{n_batches}", flush=True)

    out_path = out_path or config.model_features_file_path(model_name)
    with span("mdt.extract.save"):
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "wb") as f:
            pickle.dump(all_feats, f, protocol=pickle.HIGHEST_PROTOCOL)
    return all_feats


def import_external_features(
    stim_ids,
    feature_arrays: dict,
    model_name: str,
    out_path: str | None = None,
) -> dict:
    """Escape hatch: import externally computed features into the schema.

    The pattern of the reference's feature_extraction/transform_glow_features.py
    — align [N, D] arrays (keyed by feature key) to stimulus ids and write the
    standard pickle.  For models with no local weights and no forward here.
    """
    all_feats = {}
    for key, arr in feature_arrays.items():
        arr = np.asarray(arr, dtype=np.float32)
        assert len(arr) == len(stim_ids), (key, len(arr), len(stim_ids))
        for sid, row in zip(stim_ids, arr):
            all_feats.setdefault(int(sid), {})[key] = row
    out_path = out_path or config.model_features_file_path(model_name)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(all_feats, f, protocol=pickle.HIGHEST_PROTOCOL)
    return all_feats
