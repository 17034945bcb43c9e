"""Gray-matter mask creation from SPM segmentation.

Copy of ``multimodal_decoding_tpu/preprocessing/masks.py``,
its imports pointed at the port.

Rebuild of the reference's preprocessing/create_gray_matter_masks.py:28-39:
binarise the c1 (gray-matter probability) image at > 0 and write the mask
volume the GLM design uses as an explicit mask.
"""

from __future__ import annotations

import numpy as np

from multimodal_decoding_tpu_torch.io.nifti import read_nifti, write_nifti


def create_gray_matter_mask(c1_path: str, out_path: str, threshold: float = 0.0) -> np.ndarray:
    prob = read_nifti(c1_path).get_fdata()
    mask = (prob > threshold).astype(np.uint8)
    write_nifti(out_path, mask, descrip="gray matter mask")
    return mask
