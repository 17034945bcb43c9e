"""Whole-brain ridge decoding pipeline.

Port of ``multimodal_decoding_tpu/decoding/whole_brain.py``: the training
mode x subject x mask x model loop around one gram streamed from the host
betas (``GramCache``), the alpha CV on that gram, the strict refit and the
test/imagery predictions of the dual form (``ops/ridge.py``).  The results
pickle keeps the JAX package's schema, holds numpy arrays only (never
tensors), and lives at the same path, so each package reads and skips the
other's results.

``WholeBrainConfig.device`` picks the device (``None`` = ``cuda``, which
raises without a GPU).  ``WholeBrainConfig.mesh="auto"`` (the CLI's
``--multichip``) feature-shards the kernels over the world's ranks
(``parallel/mesh.feature_mesh``): each rank streams its column range and the
partial kernels are summed by one all_reduce; every rank then decodes the
same replicated kernels and rank 0 writes ``results.p``.  The CV selection solver is ``default_wb_cv_solver``:
``"schur-pallas"`` on CUDA, whose base blocks launch the hand-written panel
kernel (held to the strict path by chip_smoke.py phase ``wb_gate``), and the
strict Cholesky solve on the CPU.
"""

from __future__ import annotations

import os
import pickle
import time
from dataclasses import dataclass, field

import numpy as np

from multimodal_decoding_tpu_torch.config import (
    DEFAULT_ALPHAS,
    DEFAULT_MODEL,
    DEFAULT_RESOLUTION,
    MODALITY_AGNOSTIC,
    NUM_CV_SPLITS,
    RESULTS_FILE,
    RIDGE_DECODER_OUT_DIR,
    SELECT_DEFAULT,
    SPLIT_IMAGERY,
    SPLIT_TEST,
    SPLIT_TRAIN,
    SUBJECTS,
    LatentFeatsConfig,
)
from multimodal_decoding_tpu_torch.data.betas import get_fmri_data
from multimodal_decoding_tpu_torch.data.features import get_latent_features
from multimodal_decoding_tpu_torch.data.preprocess import (
    apply_mask,
    standardize_fmri_betas,
    standardize_latents,
)
from multimodal_decoding_tpu_torch.device import resolve_device, synchronize
from multimodal_decoding_tpu_torch.ops import metrics as M
from multimodal_decoding_tpu_torch.ops.precision import default_wb_cv_solver
from multimodal_decoding_tpu_torch.ops.ridge import (
    dual_ridge_predict,
    ridge_cv_dual,
    streamed_kernels,
)
from multimodal_decoding_tpu_torch.parallel.mesh import (
    FEATURE_AXIS,
    barrier,
    is_writer,
    resolve_mesh,
)
from multimodal_decoding_tpu_torch.utils.profiling import span
from multimodal_decoding_tpu_torch.utils.runlog import RunLogger


def get_run_str(betas_dir, feats_config, mask=None, surface=False,
                resolution=DEFAULT_RESOLUTION) -> str:
    """Run-identity string, reference path contract (ridge_regression_decoding.py:24-42)."""
    run_str = f"{feats_config.model}_{feats_config.combined_feats}"
    run_str += f"_{feats_config.vision_features}"
    run_str += f"_{feats_config.lang_features}"
    if betas_dir.endswith(os.sep):
        betas_dir = betas_dir[:-1]
    run_str += f"_{betas_dir.split(os.sep)[-1]}"
    if mask is not None:
        if mask.startswith("functional_") or mask.startswith("anatomical_"):
            run_str += f"_mask_{mask}"
        else:
            run_str += f"_mask_{os.path.basename(mask).replace('.p', '')}"
    if surface:
        run_str += f"_surface_{resolution}"
    return run_str


@dataclass
class WholeBrainConfig:
    betas_dir: str
    training_modes: list = field(default_factory=lambda: [MODALITY_AGNOSTIC])
    subjects: list = field(default_factory=lambda: list(SUBJECTS))
    models: list = field(default_factory=lambda: [DEFAULT_MODEL])
    features: str = SELECT_DEFAULT
    test_features: str = SELECT_DEFAULT
    vision_features: str = SELECT_DEFAULT
    lang_features: str = SELECT_DEFAULT
    alphas: tuple = DEFAULT_ALPHAS
    n_splits: int = NUM_CV_SPLITS
    surface: bool = False
    resolution: str = DEFAULT_RESOLUTION
    masks: list = field(default_factory=lambda: [None])
    overwrite: bool = False
    out_dir: str = RIDGE_DECODER_OUT_DIR
    # None: one device; "auto": the world's "f" mesh (parallel/mesh.py), or a
    # parallel/mesh.Mesh
    mesh: object = None
    device: str | None = None  # None = cuda


class GramCache:
    """Model-independent kernel matrices for one (subject, mask) dataset.

    ``K = X X^T`` and the query kernels ``K_test``, ``K_imag`` depend only on
    the betas, not on the latent model, so a multi-model sweep shares them.
    They are built in one pass over the train betas' column blocks (each
    block crosses to the device once) and stay on ``device``.  With a
    feature ``mesh`` each rank streams its column range and every rank holds
    the summed kernels on ``mesh.device``.  ``gram_seconds``: the build's
    seconds, ended by a device synchronisation (span ``mdt.gram.build``).
    """

    def __init__(self, train_betas, test_betas, imagery_betas, mesh=None, device=None):
        self.device = mesh.device if mesh is not None else resolve_device(device)
        t0 = time.perf_counter()
        with span("mdt.gram.build"):
            self.K, (self.K_test, self.K_imag) = streamed_kernels(
                train_betas, (test_betas, imagery_betas), mesh=mesh, device=self.device)
            synchronize(self.device)
        self.gram_seconds = time.perf_counter() - t0

    @classmethod
    def from_kernels(cls, K, K_test, K_imag) -> "GramCache":
        """A cache around kernels made elsewhere (tensors on one device)."""
        cache = cls.__new__(cls)
        cache.K, cache.K_test, cache.K_imag = K, K_test, K_imag
        cache.device, cache.gram_seconds = K.device, 0.0
        return cache


def decode_single(
    train_betas: np.ndarray,
    test_betas: np.ndarray,
    imagery_betas: np.ndarray,
    train_latents: np.ndarray,
    test_latents: np.ndarray,
    imagery_latents: np.ndarray,
    alphas=DEFAULT_ALPHAS,
    n_splits: int = NUM_CV_SPLITS,
    gram_cache: GramCache | None = None,
    cv_solver: str | None = "default",
    device=None,
    timings: dict | None = None,
    cv_precision=None,
):
    """One decoder fit: CV alpha sweep + refit + test/imagery predictions.

    Returns (best_alpha, test_preds, imagery_preds, cv_mean_scores, fit_s),
    numpy arrays.  ``cv_solver``: "default" resolves per device
    (default_wb_cv_solver); None forces the strict oracle; any other name is
    passed through.  ``cv_precision``: the fast selection's precision
    (``None``: ``ops/precision.default_cv_precision(device)``).  ``timings``: if a dict, it gets ``cv_s``, ``refit_s``
    and ``predict_s``, each stage ended by a device synchronisation.
    """
    device = resolve_device(device if gram_cache is None else gram_cache.device)
    t0 = time.perf_counter()
    cache = gram_cache or GramCache(train_betas, test_betas, imagery_betas, device=device)
    if cv_solver == "default":
        cv_solver = default_wb_cv_solver(device)
    best_idx, mean_scores, dual = ridge_cv_dual(
        cache.K, np.asarray(train_latents, np.float32), list(alphas),
        n_splits=n_splits, cv_solver=cv_solver, device=device, timings=timings,
        cv_precision=cv_precision,
    )
    fit_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    test_preds = dual_ridge_predict(cache.K_test, dual, device=device).cpu().numpy()
    imagery_preds = dual_ridge_predict(cache.K_imag, dual, device=device).cpu().numpy()
    if timings is not None:
        timings["predict_s"] = time.perf_counter() - t1
    return float(alphas[best_idx]), test_preds, imagery_preds, mean_scores, fit_s


def run(cfg: WholeBrainConfig) -> list:
    """Pipeline loop: training_mode x subject x mask x model (parity :45-187)."""
    mesh = resolve_mesh(cfg.mesh, FEATURE_AXIS, cfg.device)
    device = mesh.device if mesh is not None else resolve_device(cfg.device)
    all_results = []
    for training_mode in cfg.training_modes:
        for subject in cfg.subjects:
            train_full, train_ids, train_types = get_fmri_data(
                cfg.betas_dir, subject, SPLIT_TRAIN, training_mode, surface=cfg.surface
            )
            test_full, test_ids, test_types = get_fmri_data(
                cfg.betas_dir, subject, SPLIT_TEST, surface=cfg.surface
            )
            imag_full, imag_ids, imag_types = get_fmri_data(
                cfg.betas_dir, subject, SPLIT_IMAGERY, surface=cfg.surface
            )
            for mask in cfg.masks:
                mask = None if mask in ("none", "None") else mask
                mask_dict = None
                if mask is not None:
                    if not cfg.surface:
                        raise NotImplementedError("masks require surface data")
                    with open(mask, "rb") as f:
                        mask_dict = pickle.load(f)
                train_b, test_b, imag_b = apply_mask(
                    mask_dict, [train_full, test_full, imag_full]
                )
                train_b, test_b, imag_b = standardize_fmri_betas(train_b, test_b, imag_b)
                print(f"train fMRI betas shape: {train_b.shape}")

                gram_cache = None  # built lazily, shared across the model sweep
                for model in cfg.models:
                    feats_config = LatentFeatsConfig(
                        model, cfg.features, cfg.test_features, cfg.vision_features,
                        cfg.lang_features,
                    )
                    run_str = get_run_str(
                        cfg.betas_dir, feats_config, mask, cfg.surface, cfg.resolution
                    )
                    results_file_path = os.path.join(
                        cfg.out_dir, training_mode, subject, run_str, RESULTS_FILE
                    )
                    if os.path.isfile(results_file_path) and not cfg.overwrite:
                        print(f"Skipping: results already present at {results_file_path}")
                        continue

                    train_lat = get_latent_features(feats_config, subject, SPLIT_TRAIN, training_mode)
                    test_lat = get_latent_features(feats_config, subject, SPLIT_TEST)
                    imag_lat = get_latent_features(feats_config, subject, SPLIT_IMAGERY)
                    train_lat, test_lat, imag_lat = standardize_latents(
                        train_lat, test_lat, imag_lat
                    )

                    if gram_cache is None:
                        gram_cache = GramCache(train_b, test_b, imag_b, mesh=mesh,
                                               device=device)
                    best_alpha, test_preds, imag_preds, cv_scores, fit_s = decode_single(
                        train_b, test_b, imag_b, train_lat, test_lat, imag_lat,
                        cfg.alphas, cfg.n_splits, gram_cache=gram_cache, device=device,
                    )
                    print(f"Elapsed time: {int(fit_s)}s | Best alpha: {best_alpha}")

                    results = {
                        "alpha": best_alpha,
                        "model": model,
                        "subject": subject,
                        "features": feats_config.features,
                        "test_features": feats_config.test_features,
                        "vision_features": feats_config.vision_features,
                        "lang_features": feats_config.lang_features,
                        "training_mode": training_mode,
                        "mask": mask,
                        "num_voxels": test_b.shape[1],
                        "stimulus_ids": test_ids,
                        "stimulus_types": test_types,
                        "imagery_stimulus_ids": imag_ids,
                        "predictions": test_preds,
                        "imagery_predictions": imag_preds,
                        "latents": test_lat,
                        "imagery_latents": imag_lat,
                        "surface": cfg.surface,
                        "resolution": cfg.resolution,
                        "cv_mean_scores": cv_scores,
                        "fit_seconds": fit_s,
                    }
                    scores = M.calc_all_pairwise_accuracy_scores(
                        test_lat, test_preds, test_types, imag_lat, imag_preds,
                        standardize_predictions=True, device=device,
                    )
                    results.update({k: float(v) for k, v in scores.items()})
                    print(
                        f"Pairwise acc (mean): "
                        f"{np.mean((results[M.ACC_CAPTIONS], results[M.ACC_IMAGES])):.4f} | "
                        f"captions: {results[M.ACC_CAPTIONS]:.2f} | "
                        f"images: {results[M.ACC_IMAGES]:.2f} | "
                        f"imagery: {results[M.ACC_IMAGERY]:.2f} | "
                        f"imagery whole test: {results[M.ACC_IMAGERY_WHOLE_TEST]:.2f}"
                    )

                    if is_writer(mesh):
                        os.makedirs(os.path.dirname(results_file_path), exist_ok=True)
                        with open(results_file_path, "wb") as f:
                            pickle.dump(results, f)
                        RunLogger(results_file_path + ".runlog.jsonl", echo=False).event(
                            "whole_brain_decode",
                            subject=subject, model=model, training_mode=training_mode,
                            best_alpha=best_alpha, fit_seconds=fit_s,
                            num_voxels=int(test_b.shape[1]),
                            scores={k: float(v) for k, v in scores.items()},
                        )
                    # a later model's skip check runs after this write on every
                    # rank (no collective orders them otherwise)
                    barrier(mesh)
                    all_results.append(results)

                    scores_no_std = M.calc_all_pairwise_accuracy_scores(
                        test_lat, test_preds, test_types, imag_lat, imag_preds,
                        standardize_predictions=False, device=device,
                    )
                    print(
                        "Without standardization of predictions: "
                        f"captions: {float(scores_no_std[M.ACC_CAPTIONS]):.2f} | "
                        f"images: {float(scores_no_std[M.ACC_IMAGES]):.2f}"
                    )
    return all_results
