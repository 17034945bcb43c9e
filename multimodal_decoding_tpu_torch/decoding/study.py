"""Full-study orchestration: searchlights (3 modes, with nulls) -> group stats.

Port of ``multimodal_decoding_tpu/decoding/study.py``.  The reference
pipeline is a DAG of separate CLIs the user must sequence by hand
(searchlight per training mode with --create-null-distr, then
searchlight_permutation_testing).  This driver runs the whole study from one
config with the same idempotent skip/resume behaviour at every stage, on
``StudyConfig.device`` (``None`` = ``cuda``, which raises without a GPU) or,
with ``StudyConfig.mesh``, on every rank of a ``"v"`` mesh: the searchlight
blocks and the group permutations are split over the ranks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace

from multimodal_decoding_tpu_torch.config import (
    DEFAULT_ALPHAS,
    DEFAULT_MODEL,
    DEFAULT_RESOLUTION,
    METRIC_MOD_AGNOSTIC_AND_CROSS,
    SEARCHLIGHT_OUT_DIR,
    SELECT_DEFAULT,
    SUBJECTS,
    TRAINING_MODES,
)
from multimodal_decoding_tpu_torch.decoding.permutation import PermutationConfig
from multimodal_decoding_tpu_torch.decoding.permutation import run as run_permutation
from multimodal_decoding_tpu_torch.decoding.searchlight import SearchlightConfig
from multimodal_decoding_tpu_torch.decoding.searchlight import run as run_searchlight_driver
from multimodal_decoding_tpu_torch.io.surface import edge_lengths
from multimodal_decoding_tpu_torch.parallel.mesh import VERTEX_AXIS, resolve_mesh


@dataclass
class StudyConfig:
    betas_dir: str
    meshes: dict  # {hemi: SurfaceMesh} (inflated geometry)
    model: str = DEFAULT_MODEL
    features: str = SELECT_DEFAULT
    subjects: list = field(default_factory=lambda: list(SUBJECTS))
    training_modes: list = field(default_factory=lambda: list(TRAINING_MODES))
    hemis: list = field(default_factory=lambda: ["left", "right"])
    resolution: str = DEFAULT_RESOLUTION
    # fixed ridge alpha, or the string "cv" for per-vertex alpha-CV over
    # config.DEFAULT_ALPHAS (the BASELINE configuration)
    l2_regularization_alpha: float | str = 1.0
    n_neighbors: int | None = 750
    radius: float | None = None
    n_permutations_per_subject: int = 100
    n_permutations_group_level: int = 10000
    p_value_threshold: float = 1e-4
    metric: str = METRIC_MOD_AGNOSTIC_AND_CROSS
    tfce_h: float = 2.0
    tfce_e: float = 1.0
    tfce_dh: float = 0.1
    searchlight_out_dir: str | None = None
    permutation_out_dir: str | None = None
    block_size: int | None = None
    # the searchlight stage's bf16 X_all storage and "default" products
    fast_math: bool = False
    progress: bool = True
    # adjacency build cache, shared across every (subject, mode, hemi) run
    # of the study: the kNN build is identical for all of them.  "auto" =
    # <searchlight_out_dir>/.adjacency_cache (the CLI default); None disables.
    adjacency_cache_dir: str | None = "auto"
    # None: one device; "auto": the world's "v" mesh (parallel/mesh.py)
    mesh: object = None
    device: str | None = None  # None = cuda


def run_study(cfg: StudyConfig) -> dict:
    """Searchlight all training modes (with nulls) then permutation testing."""
    coords = {h: m.coordinates for h, m in cfg.meshes.items()}
    mesh = resolve_mesh(cfg.mesh, VERTEX_AXIS, cfg.device)
    # "cv" is the permutation stage's artifact path key; the searchlight
    # stage realises it as per-vertex alpha-CV over DEFAULT_ALPHAS
    # (SearchlightConfig.alphas_cv), which writes under that same key
    cv = cfg.l2_regularization_alpha == "cv"
    adj_cache = cfg.adjacency_cache_dir
    if adj_cache == "auto":
        adj_cache = os.path.join(
            cfg.searchlight_out_dir or SEARCHLIGHT_OUT_DIR, ".adjacency_cache")
    base_sl = SearchlightConfig(
        betas_dir=cfg.betas_dir,
        mesh_coords=coords,
        model=cfg.model,
        features=cfg.features,
        subjects=cfg.subjects,
        hemis=cfg.hemis,
        resolution=cfg.resolution,
        l2_regularization_alpha=1.0 if cv else cfg.l2_regularization_alpha,
        alphas_cv=list(DEFAULT_ALPHAS) if cv else None,
        n_neighbors=cfg.n_neighbors,
        radius=cfg.radius,
        create_null_distr=True,
        n_permutations_per_subject=cfg.n_permutations_per_subject,
        block_size=cfg.block_size,
        out_dir=cfg.searchlight_out_dir,
        fast_math=cfg.fast_math,
        progress=cfg.progress,
        adjacency_cache_dir=adj_cache,
        mesh=mesh,
        device=cfg.device,
    )
    searchlight_outputs = []
    for mode in cfg.training_modes:
        searchlight_outputs += run_searchlight_driver(
            replace(base_sl, training_modes=[mode])
        )

    edges_by_hemi = {h: edge_lengths(m) for h, m in cfg.meshes.items()}
    pcfg = PermutationConfig(
        subjects=cfg.subjects,
        model=cfg.model,
        features=cfg.features,
        mod_specific_images_model=cfg.model,
        mod_specific_images_features=cfg.features,
        mod_specific_captions_model=cfg.model,
        mod_specific_captions_features=cfg.features,
        l2_regularization_alpha=cfg.l2_regularization_alpha,
        resolution=cfg.resolution,
        n_neighbors=cfg.n_neighbors,
        radius=cfg.radius,
        tfce_h=cfg.tfce_h,
        tfce_e=cfg.tfce_e,
        tfce_dh=cfg.tfce_dh,
        metric=cfg.metric,
        n_permutations_group_level=cfg.n_permutations_group_level,
        p_value_threshold=cfg.p_value_threshold,
        hemis=cfg.hemis,
        edges_by_hemi=edges_by_hemi,
        searchlight_out_dir=cfg.searchlight_out_dir,
        out_dir=cfg.permutation_out_dir,
        device=cfg.device,
    )
    stats = run_permutation(pcfg, mesh=mesh)
    stats["searchlight_outputs"] = searchlight_outputs
    stats["permutation_config"] = pcfg
    return stats
