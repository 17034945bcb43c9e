"""Generative simulation of modality-agnostic vs modality-specific decoding.

Port of ``multimodal_decoding_tpu/analysis/simulation.py`` (the reference's
modeling_decoding.py:21-228): synthetic two-modality class data under 12
generative conditions, decoded by modality-agnostic and modality-specific
classifiers.  The data generation is a copy (numpy ``default_rng``, the same
arrays bit for bit); the classifier, sklearn's ``make_pipeline(StandardScaler,
RidgeClassifier)`` in closed form, runs on the device: one gram, one
Cholesky and one solve per fit in strict float32.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_decoding_tpu_torch.device import as_float32, resolve_device

N_CLASSES = 70
N_TRAIN_SAMPLES_PER_CLASS = 100
N_TEST_SAMPLES_PER_CLASS = 1000
N_VOXELS_FMRI = 200
STDDEV_WITHIN_CLASS = 1.5

SECOND_MODALITY_CONDITIONS = [
    "gauss_same_stddev",
    "gauss_smaller_stddev",
    "gauss_higher_stddev",
    "offset",
    "inverse",
    "orthogonal",
    "independent",
    "half_independent_half_same",
    "three_quarters_noise_quarter_same",
    "half_noise_half_same",
    "quarter_noise_three_quarters_same",
    "just_noise",
]


def _mod2_prototypes(protos, protos_indep, condition, rng):
    """Class prototypes for the second modality under each condition
    (modeling_decoding.py:44-165 semantics, vectorised over classes)."""
    n, v = protos.shape
    if condition in ("gauss_same_stddev", "gauss_smaller_stddev", "gauss_higher_stddev",
                    "offset"):
        base = protos + (1.0 if condition == "offset" else 0.0)
        return base
    if condition == "inverse":
        return -protos
    if condition == "orthogonal":
        out = np.empty_like(protos)
        for c in range(n):
            k = protos[c]
            x = rng.standard_normal(v)
            x -= x.dot(k) * k
            x /= np.linalg.norm(x)
            out[c] = x
        return out
    if condition == "independent":
        return protos_indep
    if condition == "half_independent_half_same":
        h = round(v / 2)
        return np.concatenate([protos_indep[:, :h], protos[:, h:]], axis=1)
    if condition == "three_quarters_noise_quarter_same":
        q = round(v / 4)
        return np.concatenate([np.zeros((n, 3 * q)), protos[:, :q]], axis=1)[:, :v]
    if condition == "half_noise_half_same":
        h = round(v / 2)
        return np.concatenate([np.zeros((n, h)), protos[:, h:]], axis=1)
    if condition == "quarter_noise_three_quarters_same":
        q = round(v / 4)
        return np.concatenate([np.zeros((n, q)), protos[:, q:]], axis=1)
    if condition == "just_noise":
        return np.zeros_like(protos)
    raise RuntimeError(f"Unknown second modality option: {condition}")


def _noise_scale(condition):
    return {
        "gauss_smaller_stddev": 0.5 * STDDEV_WITHIN_CLASS,
        "gauss_higher_stddev": 2.0 * STDDEV_WITHIN_CLASS,
    }.get(condition, STDDEV_WITHIN_CLASS)


def generate_condition_data(condition, seed, n_train_per_class=N_TRAIN_SAMPLES_PER_CLASS,
                            n_test_per_class=N_TEST_SAMPLES_PER_CLASS,
                            n_classes=N_CLASSES, n_voxels=N_VOXELS_FMRI):
    """Synthetic class data for both modalities (vectorised)."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(size=(n_classes, n_voxels))
    protos_indep = rng.uniform(size=(n_classes, n_voxels))
    protos2 = _mod2_prototypes(protos, protos_indep, condition, rng)
    s2 = _noise_scale(condition)

    def samples(p, n_per, scale):
        noise = rng.normal(scale=scale, size=(n_classes, n_per, n_voxels))
        data = (p[:, None, :] + noise).reshape(-1, n_voxels)
        labels = np.repeat(np.arange(n_classes), n_per)
        return data.astype(np.float32), labels

    tr1, ltr1 = samples(protos, n_train_per_class, STDDEV_WITHIN_CLASS)
    te1, lte1 = samples(protos, n_test_per_class, STDDEV_WITHIN_CLASS)
    tr2, ltr2 = samples(protos2, n_train_per_class, s2)
    te2, lte2 = samples(protos2, n_test_per_class, s2)
    return (tr1, ltr1), (te1, lte1), (tr2, ltr2), (te2, lte2)


def ridge_classifier_fit_predict(train_x, train_y, test_xs, alpha=1.0, n_classes=N_CLASSES,
                                 device=None):
    """StandardScaler + RidgeClassifier closed-form, on the device.

    sklearn semantics: z-score features (train-fit, population std, a
    constant feature scaled by 1), regress one-vs-rest {-1, +1} targets with
    ridge (with intercept: centred columns and targets, the intercept
    recovered from the means), predict the first argmax.  Returns one numpy
    label array per test set.
    """
    dev = resolve_device(device)
    x = as_float32(train_x, dev)
    mean = x.mean(dim=0)
    sd = x.std(dim=0, correction=0)
    std = torch.where(sd == 0, torch.ones_like(sd), sd)
    xs = (x - mean) / std
    t = -torch.ones((x.shape[0], n_classes), dtype=torch.float32, device=dev)
    labels = torch.as_tensor(np.asarray(train_y), dtype=torch.int64, device=dev)
    t[torch.arange(x.shape[0], device=dev), labels] = 1.0

    xs_mean, t_mean = xs.mean(dim=0), t.mean(dim=0)
    xc, tc = xs - xs_mean, t - t_mean
    A = xc.T @ xc + alpha * torch.eye(xc.shape[1], dtype=torch.float32, device=dev)
    W = torch.cholesky_solve(xc.T @ tc, torch.linalg.cholesky(A))
    b = t_mean - xs_mean @ W

    preds = []
    for test_x in test_xs:
        q = (as_float32(test_x, dev) - mean) / std
        preds.append(torch.argmax(q @ W + b, dim=1).cpu().numpy())
    return preds


def train_and_eval(condition, alpha=1.0, n_seeds=10,
                   n_train_per_class=N_TRAIN_SAMPLES_PER_CLASS,
                   n_test_per_class=N_TEST_SAMPLES_PER_CLASS,
                   n_classes=N_CLASSES, n_voxels=N_VOXELS_FMRI, device=None) -> list:
    """Rows of {condition, acc, modality, decoder_type} per seed
    (modeling_decoding.py:190-228)."""
    rows = []
    for decoder_type in ("modality_agnostic", "modality_specific_mod1", "modality_specific_mod2"):
        for seed in range(n_seeds):
            (tr1, ltr1), (te1, lte1), (tr2, ltr2), (te2, lte2) = generate_condition_data(
                condition, seed, n_train_per_class, n_test_per_class, n_classes, n_voxels
            )
            if decoder_type == "modality_agnostic":
                tx, ty = np.concatenate([tr1, tr2]), np.concatenate([ltr1, ltr2])
            elif decoder_type == "modality_specific_mod1":
                tx, ty = tr1, ltr1
            else:
                tx, ty = tr2, ltr2
            p1, p2 = ridge_classifier_fit_predict(tx, ty, [te1, te2], alpha, n_classes,
                                                  device)
            acc1 = float(np.mean(p1 == lte1))
            acc2 = float(np.mean(p2 == lte2))
            rows.append({"condition": condition, "acc": acc1, "modality": "mod1",
                         "decoder_type": decoder_type})
            rows.append({"condition": condition, "acc": acc2, "modality": "mod2",
                         "decoder_type": decoder_type})
            rows.append({"condition": condition, "acc": (acc1 + acc2) / 2,
                         "modality": "avg", "decoder_type": decoder_type})
    return rows


def run_all_conditions(alpha=1.0, n_seeds=10, device=None, **scale_kwargs):
    rows = []
    for condition in SECOND_MODALITY_CONDITIONS:
        rows.extend(train_and_eval(condition, alpha, n_seeds, device=device, **scale_kwargs))
    return rows
