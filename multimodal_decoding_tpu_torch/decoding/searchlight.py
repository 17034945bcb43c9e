"""Surface searchlight pipeline driver.

Port of ``multimodal_decoding_tpu/decoding/searchlight.py``: the subject x
training-mode x hemisphere loop around the single-device runner
(``parallel/searchlight_runner.py``).  The results pickle keeps the JAX
package's schema ({nan_locations, adjacency, n_neighbors, distances,
score_maps, scores, best_alpha, elapsed_s, vertices_per_sec}) and the null
distributions go to one ``null_distr.npz`` per (subject, mode, hemi), so
each package reads the other's outputs.

``SearchlightConfig.device`` picks the device (``None`` = ``cuda``, which
raises without a GPU).  The CV fast path (``fast_cv=True``) selects alphas
with ``default_cv_solver`` and the scale-invariant fold scorer; the refit is
always the strict Cholesky solve.
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass, field

import numpy as np

from multimodal_decoding_tpu_torch.config import (
    DEFAULT_MODEL,
    DEFAULT_RESOLUTION,
    MODALITY_AGNOSTIC,
    SEARCHLIGHT_OUT_DIR,
    SELECT_DEFAULT,
    SPLIT_IMAGERY,
    SPLIT_TEST,
    SPLIT_TRAIN,
    SUBJECTS,
    LatentFeatsConfig,
)
from multimodal_decoding_tpu_torch.data.betas import get_fmri_surface_data
from multimodal_decoding_tpu_torch.data.features import get_latent_features
from multimodal_decoding_tpu_torch.data.preprocess import (
    standardize_fmri_betas,
    standardize_latents,
)
from multimodal_decoding_tpu_torch.data.stimuli import (
    TEST_STIM_TYPES,
    create_null_distr_shuffled_indices,
)
from multimodal_decoding_tpu_torch.device import resolve_device
from multimodal_decoding_tpu_torch.io import artifacts
from multimodal_decoding_tpu_torch.io.surface import knn_adjacency, radius_adjacency
from multimodal_decoding_tpu_torch.ops import metrics as M
from multimodal_decoding_tpu_torch.parallel.searchlight_runner import run_searchlight
from multimodal_decoding_tpu_torch.utils.runlog import RunLogger


def default_cv_solver(device=None) -> str:
    """The CV-selection solver for ``device`` (``None``: the default device).

    "schur-pallas" on CUDA, so the main path runs the hand-written panel
    kernel; chip_smoke.py's selection gate holds it to the strict path.
    Elsewhere "schur-cb", as the JAX package chooses off the TPU.
    """
    if device is None:
        import torch

        on_cuda = torch.cuda.is_available()
    else:
        on_cuda = resolve_device(device).type == "cuda"
    return "schur-pallas" if on_cuda else "schur-cb"


def default_cv_dtype():
    """Selection-path storage dtype: float32 (``None``) everywhere for now."""
    return None


def default_null_gather() -> str:
    """Null-score permuted-diagonal formulation: the plain gather."""
    return "gather"


def searchlight_mode_str(radius=None, n_neighbors=None) -> str:
    """Mode string in results paths (reference searchlight.py:299-305)."""
    if radius is not None:
        return f"radius_{radius}"
    if n_neighbors is not None:
        return f"n_neighbors_{n_neighbors}"
    raise RuntimeError("Need to set either radius or n_neighbors arg!")


def get_results_dir(feats_config, hemi, subject, training_mode, resolution, mode,
                    out_dir=None) -> str:
    """Directory contract (reference searchlight.py:308-313)."""
    return os.path.join(
        out_dir or SEARCHLIGHT_OUT_DIR, training_mode, feats_config.model,
        feats_config.combined_feats, feats_config.vision_features,
        feats_config.lang_features, subject, resolution, hemi, mode,
    )


def get_results_file_path(feats_config, hemi, subject, training_mode, resolution, mode,
                          l2_regularization_alpha, out_dir=None) -> str:
    """File contract (reference searchlight.py:316-318)."""
    return os.path.join(
        get_results_dir(feats_config, hemi, subject, training_mode, resolution, mode, out_dir),
        f"alpha_{str(l2_regularization_alpha)}.p",
    )


@dataclass
class SearchlightConfig:
    betas_dir: str
    mesh_coords: dict  # {hemi: [V, 3] inflated-mesh coordinates}
    model: str = DEFAULT_MODEL
    features: str = SELECT_DEFAULT
    test_features: str = SELECT_DEFAULT
    vision_features: str = SELECT_DEFAULT
    lang_features: str = SELECT_DEFAULT
    subjects: list = field(default_factory=lambda: list(SUBJECTS))
    training_modes: list = field(default_factory=lambda: [MODALITY_AGNOSTIC])
    hemis: list = field(default_factory=lambda: ["left", "right"])
    resolution: str = DEFAULT_RESOLUTION
    l2_regularization_alpha: float = 1.0
    alphas_cv: list | None = None  # per-vertex CV when set
    radius: float | None = None
    n_neighbors: int | None = None
    create_null_distr: bool = False
    n_permutations_per_subject: int = 100
    block_size: int | None = None
    out_dir: str | None = None
    overwrite: bool = False
    progress: bool = True
    # bf16 storage is a TPU choice that waits for a gated PR (ROADMAP A15)
    fast_math: bool = False
    # CV selection with default_cv_solver and the scale-invariant scorer;
    # False selects with the strict Cholesky solve and cosine-distance scorer
    fast_cv: bool = True
    # cache directory for the kNN/radius adjacency build (None disables)
    adjacency_cache_dir: str | None = None
    # "auto"/"off" load eagerly; "on" (streamed ingestion) is ROADMAP A11.
    # None reads env MMD_STREAM_INGEST, default "auto".
    stream_ingest: bool | str | None = None
    device: str | None = None  # None = cuda


def build_adjacency(coords, nan_locations=None, radius=None, n_neighbors=None,
                    cache_dir=None, device=None):
    """Adjacency over (optionally NaN-filtered) mesh coords (reference searchlight.py:152-178).

    Returns (indices [V', K], mask or None, n_neighbors_per_vertex or None,
    distances or None).  ``cache_dir``: the result is cached as an .npz keyed
    by the (coords, radius/K) content hash, with the JAX package's key and
    payload, so the two packages share caches.  ``device`` runs the radius
    search (kNN uses scipy's exact KD-tree on the host).
    """
    coords = np.asarray(coords)
    if nan_locations is not None:
        coords = coords[~np.asarray(nan_locations)]
    if cache_dir is not None:
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(coords).tobytes())
        h.update(f"r={radius},k={n_neighbors}".encode())
        cache_path = os.path.join(cache_dir, f"adjacency_{h.hexdigest()[:16]}.npz")
        if os.path.exists(cache_path):
            with np.load(cache_path, allow_pickle=False) as z:
                print(f"Loaded cached adjacency: {cache_path}")
                return (z["idx"],
                        z["mask"] if "mask" in z.files else None,
                        z["counts"] if "counts" in z.files else None,
                        z["dists"] if "dists" in z.files else None)
        out = build_adjacency(coords, None, radius, n_neighbors, device=device)
        os.makedirs(cache_dir, exist_ok=True)
        payload = {"idx": out[0]}
        for name, val in zip(("mask", "counts", "dists"), out[1:]):
            if val is not None:
                payload[name] = val
        # atomic publish: a killed run must never leave a truncated cache
        tmp_path = cache_path + f".{os.getpid()}.tmp.npz"
        np.savez(tmp_path, **payload)
        os.replace(tmp_path, cache_path)
        return out
    if radius is not None:
        idx, mask, counts = radius_adjacency(coords, radius, device=device)
        print(
            f"Number of neighbors within {radius}mm radius: {counts.mean():.1f} "
            f"(max: {counts.max():.0f} | min: {counts.min():.0f})"
        )
        return idx, mask, counts, None
    if n_neighbors is not None:
        idx, dists = knn_adjacency(coords, n_neighbors)
        print(f"Max radius {n_neighbors} neighbors: {dists.max():.2f}mm")
        print(f"Mean radius: {dists.max(axis=1).mean():.2f}mm")
        return idx, None, None, dists
    raise RuntimeError("Need to set either radius or n_neighbors arg!")


def _check_stream_ingest(mode) -> None:
    """Resolve the ingestion mode; only the eager loader is ported."""
    if mode is None:
        mode = os.environ.get("MMD_STREAM_INGEST", "auto")
    m = str(mode).lower()
    if m in ("1", "on", "true"):
        raise NotImplementedError(
            "stream_ingest=on (streamed betas ingestion) is not ported yet (ROADMAP A11)")
    if m not in ("0", "off", "false", "auto"):
        raise ValueError(f"stream_ingest: {mode!r} (use on/off/auto)")


def run(cfg: SearchlightConfig) -> list:
    """subject x training_mode x hemi loop (reference searchlight.py:181-296)."""
    if cfg.fast_math:
        raise NotImplementedError(
            "fast_math (bf16 storage) is not ported yet (ROADMAP A15); the port runs float32")
    _check_stream_ingest(cfg.stream_ingest)
    device = resolve_device(cfg.device)
    use_cv = cfg.alphas_cv is not None
    shuffles = None
    if cfg.create_null_distr:
        shuffles = np.stack(
            create_null_distr_shuffled_indices(cfg.n_permutations_per_subject)
        ).astype(np.int32)

    mode_str = searchlight_mode_str(cfg.radius, cfg.n_neighbors)
    outputs = []
    for subject in cfg.subjects:
        for training_mode in cfg.training_modes:
            for hemi in cfg.hemis:
                feats_config = LatentFeatsConfig(
                    cfg.model, cfg.features, cfg.test_features, cfg.vision_features,
                    cfg.lang_features, verbose=False,
                )
                # CV mode stores under alpha_cv; fixed-alpha runs keep the
                # reference's alpha_<value> contract
                alpha_key = "cv" if use_cv else cfg.l2_regularization_alpha
                results_path = get_results_file_path(
                    feats_config, hemi, subject, training_mode, cfg.resolution,
                    mode_str, alpha_key, cfg.out_dir,
                )
                if os.path.isfile(results_path) and not cfg.overwrite:
                    print(f"Skipping searchlight: results at {results_path}")
                    continue

                train_fmri, _, _ = get_fmri_surface_data(
                    cfg.betas_dir, subject, SPLIT_TRAIN, training_mode, hemi
                )
                test_fmri, _, _ = get_fmri_surface_data(
                    cfg.betas_dir, subject, SPLIT_TEST, hemi=hemi
                )
                imagery_fmri, _, _ = get_fmri_surface_data(
                    cfg.betas_dir, subject, SPLIT_IMAGERY, hemi=hemi
                )
                nan_locations = np.isnan(train_fmri[0])
                train_fmri, test_fmri, imagery_fmri = standardize_fmri_betas(
                    train_fmri, test_fmri, imagery_fmri
                )

                print(
                    f"\nTRAIN MODE: {training_mode} | SUBJECT: {subject} | "
                    f"MODEL: {feats_config.model} | FEATURES: {feats_config.features} "
                    f"| HEMI: {hemi} | DEVICE: {device}"
                )

                train_lat = get_latent_features(feats_config, subject, SPLIT_TRAIN, training_mode)
                test_lat = get_latent_features(feats_config, subject, SPLIT_TEST)
                imag_lat = get_latent_features(feats_config, subject, SPLIT_IMAGERY)
                train_lat, test_lat, imag_lat = standardize_latents(
                    train_lat, test_lat, imag_lat
                )

                adjacency, adj_mask, n_neighbors_per_vertex, distances = build_adjacency(
                    cfg.mesh_coords[hemi], nan_locations, cfg.radius,
                    cfg.n_neighbors, cache_dir=cfg.adjacency_cache_dir, device=device,
                )

                t0 = time.time()
                score_maps, aux = run_searchlight(
                    train_fmri, test_fmri, imagery_fmri,
                    train_lat, test_lat, imag_lat,
                    adjacency,
                    TEST_STIM_TYPES,
                    alpha=cfg.l2_regularization_alpha,
                    alphas_cv=cfg.alphas_cv,
                    adjacency_mask=adj_mask,
                    shuffles=shuffles,
                    block_size=cfg.block_size,
                    progress=cfg.progress,
                    device=device,
                    cv_solver=(default_cv_solver(device)
                               if cfg.fast_cv and use_cv else None),
                    cv_scorer="xla" if cfg.fast_cv else "strict",
                    cv_dtype=default_cv_dtype(),
                    checkpoint_path=results_path + ".ckpt.npz",
                    # --overwrite redoes the work from scratch; a stale
                    # mid-run checkpoint must not silently resume under it
                    resume=not cfg.overwrite,
                )
                print(f"Searchlight time: {int(time.time() - t0)}s "
                      f"({aux['vertices_per_sec']:.0f} vertices/s)")

                for metric in (M.ACC_CAPTIONS, M.ACC_IMAGES, M.ACC_IMAGERY,
                               M.ACC_IMAGERY_WHOLE_TEST):
                    vals = score_maps[metric]
                    print(f"Mean score ({metric}): {np.mean(vals):.2f} | "
                          f"Max score: {np.max(vals):.2f}")

                results_dict = {
                    "nan_locations": nan_locations,
                    "adjacency": adjacency,
                    "n_neighbors": n_neighbors_per_vertex,
                    "distances": distances,
                    "score_maps": score_maps,  # canonical {metric: [V']}
                    "scores": artifacts.scores_to_list(score_maps),  # reference layout
                    "best_alpha": aux.get("best_alpha"),
                    "elapsed_s": aux["elapsed_s"],
                    "vertices_per_sec": aux["vertices_per_sec"],
                }
                artifacts.save_pickle(results_dict, results_path)
                RunLogger(results_path + ".runlog.jsonl", echo=False).event(
                    "searchlight",
                    subject=subject, training_mode=training_mode, hemi=hemi,
                    model=cfg.model, vertices_per_sec=aux["vertices_per_sec"],
                    elapsed_s=aux["elapsed_s"], block_size=aux["block_size"],
                    device=str(device),
                    mean_scores={
                        m: float(np.mean(score_maps[m]))
                        for m in (M.ACC_CAPTIONS, M.ACC_IMAGES, M.ACC_IMAGERY)
                    },
                )
                if "null_scores" in aux:
                    artifacts.save_null_scores_npz(
                        os.path.join(os.path.dirname(results_path), "null_distr.npz"),
                        aux["null_scores"],
                    )
                outputs.append(results_path)
    return outputs
