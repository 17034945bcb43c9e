"""Between-subject RSA noise ceilings.

Copy of ``multimodal_decoding_tpu/analysis/noise_ceilings.py`` (the
reference's calc_noise_ceilings.py) over the port's ``calc_rsa``: upper
ceiling = RSA of each subject's betas with the subject-average (including
itself); lower ceiling = RSA with the leave-one-out average.
Operates on the per-subject test-set beta matrices loaded via the data layer.
"""

from __future__ import annotations

import numpy as np

from multimodal_decoding_tpu_torch.ops.metrics import calc_rsa


def noise_ceilings(per_subject_betas: dict, metric: str = "spearmanr",
                   matrix_metric: str = "spearmanr") -> dict:
    """{subject: [n_stim, F]} -> {subject: (lower, upper)} RSA noise ceilings."""
    subjects = list(per_subject_betas)
    stack = np.stack([np.asarray(per_subject_betas[s], dtype=np.float64) for s in subjects])
    mean_all = stack.mean(axis=0)
    out = {}
    for i, s in enumerate(subjects):
        upper = calc_rsa(stack[i], mean_all, metric, matrix_metric)
        loo = (stack.sum(axis=0) - stack[i]) / (len(subjects) - 1)
        lower = calc_rsa(stack[i], loo, metric, matrix_metric)
        out[s] = (float(lower), float(upper))
    return out
