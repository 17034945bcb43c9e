"""Surface searchlight pipeline driver.

Port of ``multimodal_decoding_tpu/decoding/searchlight.py``: the subject x
training-mode x hemisphere loop around the runner
(``parallel/searchlight_runner.py``), on one device or, with
``SearchlightConfig.mesh``, on every rank of a ``"v"`` mesh (rank 0 writes
the artifacts).  Betas come from the eager loader or, with
``stream_ingest``, are streamed from the npz cache straight onto the device
(``parallel/ingest.py``).  The results pickle keeps the JAX
package's schema ({nan_locations, adjacency, n_neighbors, distances,
score_maps, scores, best_alpha, elapsed_s, vertices_per_sec}) and the null
distributions go to one ``null_distr.npz`` per (subject, mode, hemi), so
each package reads the other's outputs.

``SearchlightConfig.device`` picks the device (``None`` = ``cuda``, which
raises without a GPU).  The CV fast path (``fast_cv=True``) selects alphas
with the scale-invariant fold scorer and the device's shipped selection
settings, ``default_cv_solver``, ``default_cv_precision`` and
``default_cv_dtype``; the refit is always the strict Cholesky solve.
``fast_math`` stores ``X_all`` in bf16 and runs the fit's and the
predictions' products at ``"default"``, one bf16 pass
(``ops/precision.py``); the strict Cholesky solve and the scores'
distances stay float32, and the CV selection keeps its own settings
(``default_cv_precision``, ``"highest"``, and ``default_cv_dtype``,
float32), so its products are not one bf16 pass.
``precision_arguments`` is the one mapping of these flags to the runner's
arguments.
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

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
from multimodal_decoding_tpu_torch.data.betas import get_fmri_surface_data, surface_cache_path
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
from multimodal_decoding_tpu_torch.ops.precision import (
    default_cv_dtype,
    default_cv_precision,
    default_cv_solver,
)
from multimodal_decoding_tpu_torch.parallel.ingest import (
    NpzMemberReader,
    streamed_scaler_fit,
    streamed_x_all_device,
)
from multimodal_decoding_tpu_torch.parallel.mesh import (
    VERTEX_AXIS,
    barrier,
    is_writer,
    resolve_mesh,
)
from multimodal_decoding_tpu_torch.parallel.searchlight_runner import run_searchlight
from multimodal_decoding_tpu_torch.utils.runlog import RunLogger


def precision_arguments(fast_math: bool, fast_cv: bool = True, alphas_cv=None,
                        device=None) -> dict:
    """The runner's precision arguments (``dtype``, ``precision``,
    ``cv_precision``, ``cv_solver``, ``cv_scorer``, ``cv_dtype``) for the
    flags ``fast_math`` and ``fast_cv`` and the CV grid ``alphas_cv`` (None:
    a fixed alpha) on ``device``, as ``run`` passes them."""
    fast_sel = fast_cv and alphas_cv is not None
    return dict(
        dtype=torch.bfloat16 if fast_math else torch.float32,
        precision="default" if fast_math else "highest",
        cv_precision=default_cv_precision(device) if fast_sel else None,
        cv_solver=default_cv_solver(device) if fast_sel else None,
        cv_scorer="xla" if fast_cv else "strict",
        cv_dtype=default_cv_dtype(device) if fast_sel else None,
    )


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
    # bf16 X_all storage and the fit's and predictions' products at
    # "default" (one bf16 pass); see precision_arguments
    fast_math: bool = False
    # CV selection with the scale-invariant scorer at the device's shipped
    # default_cv_solver / default_cv_precision / default_cv_dtype; False
    # selects with the strict Cholesky solve and cosine-distance scorer
    fast_cv: bool = True
    # cache directory for the kNN/radius adjacency build (None disables)
    adjacency_cache_dir: str | None = None
    # streamed ingestion from the betas npz cache (parallel/ingest.py):
    # "on" streams (the cache must exist), "off" loads eagerly, "auto"
    # streams float32 caches over STREAM_AUTO_MIN_BYTES.  None reads env
    # MMD_STREAM_INGEST, default "auto".
    stream_ingest: bool | str | None = None
    # None: one device; "auto": the world's "v" mesh (parallel/mesh.py)
    mesh: object = None
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


#: "auto" streams a train betas cache larger than this (the JAX package's rule)
STREAM_AUTO_MIN_BYTES = 2 << 30


def _stream_ingest_mode(mode):
    """``stream_ingest`` as True (on), False (off) or "auto"; None reads env
    MMD_STREAM_INGEST (default "auto")."""
    if mode is None:
        mode = os.environ.get("MMD_STREAM_INGEST", "auto")
    if isinstance(mode, bool):
        return mode
    m = str(mode).lower()
    if m in ("1", "on", "true"):
        return True
    if m in ("0", "off", "false"):
        return False
    if m == "auto":
        return "auto"
    raise ValueError(f"stream_ingest: {mode!r} (use on/off/auto)")


def _stream_ingest_readers(cfg: SearchlightConfig, subject, training_mode, hemi):
    """Resolve the streaming-ingestion decision for one (subject, mode, hemi).

    Returns [train, test, imagery] ``NpzMemberReader`` over the betas npz
    caches, or None for the eager path.  "on" raises when the caches are
    missing or not float32; "auto" streams only float32 caches whose train
    file exceeds ``STREAM_AUTO_MIN_BYTES``, and otherwise loads eagerly (the
    eager run builds the cache, so the next run streams).  Under a mesh
    each rank streams its own replica.
    """
    mode = _stream_ingest_mode(cfg.stream_ingest)
    if mode is False:
        return None
    paths = [
        surface_cache_path(cfg.betas_dir, subject, SPLIT_TRAIN, training_mode, hemi),
        surface_cache_path(cfg.betas_dir, subject, SPLIT_TEST, hemi=hemi),
        surface_cache_path(cfg.betas_dir, subject, SPLIT_IMAGERY, hemi=hemi),
    ]
    missing = [p for p in paths if not os.path.isfile(p)]
    if mode is True:
        if missing:
            raise FileNotFoundError(
                f"stream_ingest=on but the betas npz cache is missing: "
                f"{missing[0]} (run once with the eager loader to build it)"
            )
    elif missing or os.path.getsize(paths[0]) <= STREAM_AUTO_MIN_BYTES:
        return None
    try:
        readers = [NpzMemberReader(p) for p in paths]
    except ValueError:
        if mode is True:
            raise
        return None
    if any(r.dtype != np.float32 for r in readers):
        if mode is True:
            raise ValueError("streaming ingestion requires float32 betas caches")
        return None
    print("Streaming ingestion: standardize + upload in O(chunk) host RAM "
          "(parallel/ingest.py)")
    return readers


def run(cfg: SearchlightConfig) -> list:
    """subject x training_mode x hemi loop (reference searchlight.py:181-296)."""
    _stream_ingest_mode(cfg.stream_ingest)  # a bad value fails before any work
    mesh = resolve_mesh(cfg.mesh, VERTEX_AXIS, cfg.device)
    device = mesh.device if mesh is not None else resolve_device(cfg.device)
    use_cv = cfg.alphas_cv is not None
    precision_args = precision_arguments(cfg.fast_math, cfg.fast_cv, cfg.alphas_cv, device)
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

                stream_readers = _stream_ingest_readers(cfg, subject, training_mode, hemi)
                x_all_device = n_rows_split = None
                if stream_readers is not None:
                    train_fmri = test_fmri = imagery_fmri = None
                    nan_locations = np.isnan(stream_readers[0].read_row(0))
                    keep = ~nan_locations
                    mean32, scale32 = streamed_scaler_fit(stream_readers[0], keep)
                    x_all_device = streamed_x_all_device(stream_readers, keep, mean32,
                                                         scale32, device=device,
                                                         dtype=precision_args["dtype"])
                    n_rows_split = tuple(r.n_rows for r in stream_readers)
                else:
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
                    mesh=mesh,
                    device=device,
                    x_all_device=x_all_device,
                    n_rows_split=n_rows_split,
                    **precision_args,
                    checkpoint_path=results_path + ".ckpt.npz",
                    # --overwrite redoes the work from scratch; a stale
                    # mid-run checkpoint must not silently resume under it
                    resume=not cfg.overwrite,
                )
                del x_all_device
                print(f"Searchlight time: {int(time.time() - t0)}s "
                      f"({aux['vertices_per_sec']:.0f} vertices/s)")

                for metric in (M.ACC_CAPTIONS, M.ACC_IMAGES, M.ACC_IMAGERY,
                               M.ACC_IMAGERY_WHOLE_TEST):
                    vals = score_maps[metric]
                    print(f"Mean score ({metric}): {np.mean(vals):.2f} | "
                          f"Max score: {np.max(vals):.2f}")

                outputs.append(results_path)
                if not is_writer(mesh):
                    continue
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
    barrier(mesh)  # every rank returns after rank 0 has written the artifacts
    return outputs
