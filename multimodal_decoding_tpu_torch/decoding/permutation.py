"""Group-level permutation testing pipeline on one GPU or a ``"v"`` mesh.

Port of ``multimodal_decoding_tpu/decoding/permutation.py``:

* per-vertex score lists -> full-vertex maps (``process_scores``): numpy
  scatter on dict-of-array score maps, a copy;
* observed t-maps + composite min-metrics: one batched pass on the device
  (``ops/stats.t_map``), float32 as in the JAX package;
* the group null: the per-subject null score tensors ``[S, P_within, V]`` of
  the composite's member metrics live on the device, and each chunk of
  group permutations is a gather + t-reduction per member with the member
  minimum taken on the device (``ops/stats.null_min_t_sweep``).  Only that
  ``[chunk, V]`` minimum crosses to the host, where the native TFCE engine
  (``ops/tfce.py``) reduces it to one max statistic per permutation.  The
  loop runs chunk-outer, so the full ``[P_group, V]`` t-maps are never held
  (the JAX package keeps them on the host: 6.5 GB a hemisphere at 10,000
  permutations on fsaverage7);
* storage: only the per-permutation max TFCE statistic across hemispheres
  is kept (``null_max<suffix>.npz``); ``keep_null_maps=True`` also writes
  the full TFCE maps.

Every stage's output is cached at the JAX package's paths and layouts
(``t_values.p``, ``tfce_values<suffix>.p``, ``null_max<suffix>.npz``,
``p_values<suffix>.p``, ``results_maps/*.gii``, ``masks<suffix>.p``,
``clusters<suffix>.p``) and skipped when present, so each package resumes
from, and reads, the other's artifacts.  ``PermutationConfig.device`` picks
the device (``None`` = ``cuda``, which raises without a GPU).

With a ``mesh`` (``parallel/mesh.vertex_mesh``, one process per GPU), each
rank reads the null artifacts of its own subjects and one all_reduce
assembles the stacks on every rank (``_stacked_null_scores``); each chunk of
group permutations is split over the ranks and its min-maps all-gathered
(``ops/stats.null_min_t_sweep``); every rank runs TFCE on all of them, as
the JAX package does, and only rank 0 writes artifacts.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from multimodal_decoding_tpu_torch.config import (
    DEFAULT_MODEL,
    DEFAULT_RESOLUTION,
    HEMIS,
    METRIC_CAPTIONS_DIFF_MOD_AGNO_MOD_SPECIFIC,
    METRIC_IMAGES_DIFF_MOD_AGNO_MOD_SPECIFIC,
    METRIC_MOD_AGNOSTIC_AND_CROSS,
    MODALITY_AGNOSTIC,
    MODALITY_SPECIFIC_CAPTIONS,
    MODALITY_SPECIFIC_IMAGES,
    SEARCHLIGHT_PERMUTATION_TESTING_RESULTS_DIR,
    SELECT_DEFAULT,
    SUBJECTS,
    LatentFeatsConfig,
)
from multimodal_decoding_tpu_torch.decoding.searchlight import (
    get_results_file_path,
    searchlight_mode_str,
)
from multimodal_decoding_tpu_torch.device import resolve_device
from multimodal_decoding_tpu_torch.io import artifacts
from multimodal_decoding_tpu_torch.io.gifti import export_to_gifti
from multimodal_decoding_tpu_torch.ops import metrics as M
from multimodal_decoding_tpu_torch.ops import stats as S
from multimodal_decoding_tpu_torch.ops import tfce as T
from multimodal_decoding_tpu_torch.parallel.mesh import barrier, is_writer
from multimodal_decoding_tpu_torch.parallel.multihost import (
    host_shard_bounds,
    replicate_host_filled,
)


# ---------------------------------------------------------------------------
# Score assembly (process_scores parity, permutation_testing.py:51-99)
# ---------------------------------------------------------------------------


def _scatter(values: np.ndarray, nan_locations: np.ndarray) -> np.ndarray:
    """[V'] (or [V', ...]) valid-vertex values -> [V, ...] with NaN elsewhere."""
    values = np.asarray(values)
    out_shape = (len(nan_locations),) + values.shape[1:]
    out = np.full(out_shape, np.nan, dtype=np.float64)
    out[~nan_locations] = values
    return out


def process_scores(scores_agnostic, scores_mod_specific_captions, scores_mod_specific_images,
                   nan_locations, additional_imagery_scores=False) -> dict:
    """Map split-specific metric names onto the analysis vocabulary.

    Inputs are {metric: [V']} dicts (our canonical form; use
    artifacts.list_to_scores for reference-layout pickles).
    """
    nan_locations = np.asarray(nan_locations)
    out = {}

    agnostic_pairs = [
        (M.ACC_CAPTIONS_MOD_AGNOSTIC, M.ACC_CAPTIONS),
        (M.ACC_IMAGES_MOD_AGNOSTIC, M.ACC_IMAGES),
        (M.ACC_IMAGERY_MOD_AGNOSTIC, M.ACC_IMAGERY),
        (M.ACC_IMAGERY_WHOLE_TEST_SET_MOD_AGNOSTIC, M.ACC_IMAGERY_WHOLE_TEST),
    ]
    for name, metric in agnostic_pairs:
        out[name] = _scatter(scores_agnostic[metric], nan_locations)

    if scores_mod_specific_captions is not None and scores_mod_specific_images is not None:
        cap_pairs = [
            (M.ACC_CAPTIONS_MOD_SPECIFIC_CAPTIONS, M.ACC_CAPTIONS),
            (M.ACC_IMAGES_MOD_SPECIFIC_CAPTIONS, M.ACC_IMAGES),
        ]
        if additional_imagery_scores:
            cap_pairs += [
                (M.ACC_IMAGERY_MOD_SPECIFIC_CAPTIONS, M.ACC_IMAGERY),
                (M.ACC_IMAGERY_WHOLE_TEST_SET_MOD_SPECIFIC_CAPTIONS, M.ACC_IMAGERY_WHOLE_TEST),
                (M.ACC_IMAGERY_NO_STD_MOD_SPECIFIC_CAPTIONS, M.ACC_IMAGERY + "_no_std"),
                (
                    M.ACC_IMAGERY_WHOLE_TEST_SET_NO_STD_MOD_SPECIFIC_CAPTIONS,
                    M.ACC_IMAGERY_WHOLE_TEST + "_no_std",
                ),
            ]
        for name, metric in cap_pairs:
            out[name] = _scatter(scores_mod_specific_captions[metric], nan_locations)

        img_pairs = [
            (M.ACC_IMAGES_MOD_SPECIFIC_IMAGES, M.ACC_IMAGES),
            (M.ACC_CAPTIONS_MOD_SPECIFIC_IMAGES, M.ACC_CAPTIONS),
        ]
        if additional_imagery_scores:
            img_pairs += [
                (M.ACC_IMAGERY_MOD_SPECIFIC_IMAGES, M.ACC_IMAGERY),
                (M.ACC_IMAGERY_WHOLE_TEST_SET_MOD_SPECIFIC_IMAGES, M.ACC_IMAGERY_WHOLE_TEST),
                (M.ACC_IMAGERY_NO_STD_MOD_SPECIFIC_IMAGES, M.ACC_IMAGERY + "_no_std"),
                (
                    M.ACC_IMAGERY_WHOLE_TEST_SET_NO_STD_MOD_SPECIFIC_IMAGES,
                    M.ACC_IMAGERY_WHOLE_TEST + "_no_std",
                ),
            ]
        for name, metric in img_pairs:
            out[name] = _scatter(scores_mod_specific_images[metric], nan_locations)

        out[METRIC_IMAGES_DIFF_MOD_AGNO_MOD_SPECIFIC] = (
            out[M.ACC_IMAGES_MOD_AGNOSTIC] - out[M.ACC_IMAGES_MOD_SPECIFIC_IMAGES]
        )
        out[METRIC_CAPTIONS_DIFF_MOD_AGNO_MOD_SPECIFIC] = (
            out[M.ACC_CAPTIONS_MOD_AGNOSTIC] - out[M.ACC_CAPTIONS_MOD_SPECIFIC_CAPTIONS]
        )
    return out


# ---------------------------------------------------------------------------
# Config & artifact paths
# ---------------------------------------------------------------------------


@dataclass
class PermutationConfig:
    subjects: list = field(default_factory=lambda: list(SUBJECTS))
    model: str = DEFAULT_MODEL
    features: str = SELECT_DEFAULT
    test_features: str = SELECT_DEFAULT
    vision_features: str = SELECT_DEFAULT
    lang_features: str = SELECT_DEFAULT
    mod_specific_images_model: str = DEFAULT_MODEL
    mod_specific_images_features: str = SELECT_DEFAULT
    mod_specific_images_test_features: str = SELECT_DEFAULT
    mod_specific_captions_model: str = DEFAULT_MODEL
    mod_specific_captions_features: str = SELECT_DEFAULT
    mod_specific_captions_test_features: str = SELECT_DEFAULT
    # fixed alpha of the searchlight artifacts, or the string "cv" for
    # per-vertex alpha-CV runs (their results live under alpha_cv.p)
    l2_regularization_alpha: float | str = 1.0
    resolution: str = DEFAULT_RESOLUTION
    radius: float | None = None
    n_neighbors: int | None = None
    tfce_h: float = 2.0
    tfce_e: float = 1.0
    tfce_dh: float = 0.1
    metric: str = METRIC_MOD_AGNOSTIC_AND_CROSS
    n_permutations_group_level: int = 10000
    p_value_threshold: float = 1e-4
    tfce_value_threshold: float | None = None
    hemis: list = field(default_factory=lambda: list(HEMIS))
    # mesh edges per hemi: {hemi: (edges [E,2], lengths [E])}
    edges_by_hemi: dict | None = None
    searchlight_out_dir: str | None = None
    out_dir: str | None = None
    null_chunk: int = 256
    keep_null_maps: bool = False
    device: str | None = None  # None = cuda


def permutation_results_dir(cfg: PermutationConfig) -> str:
    """Directory contract (parity: permutation_testing.py:559-564)."""
    return os.path.join(
        cfg.out_dir or SEARCHLIGHT_PERMUTATION_TESTING_RESULTS_DIR,
        cfg.model, cfg.features, cfg.mod_specific_images_model,
        cfg.mod_specific_images_features, cfg.mod_specific_captions_model,
        cfg.mod_specific_captions_features, cfg.resolution,
        searchlight_mode_str(cfg.radius, cfg.n_neighbors),
    )


def get_hparam_suffix(cfg: PermutationConfig) -> str:
    return f"_{cfg.metric}_h_{cfg.tfce_h}_e_{cfg.tfce_e}_dh_{cfg.tfce_dh}"


def _results_path(cfg, feats, hemi, subject, mode):
    return get_results_file_path(
        feats, hemi, subject, mode, cfg.resolution,
        searchlight_mode_str(cfg.radius, cfg.n_neighbors),
        cfg.l2_regularization_alpha, cfg.searchlight_out_dir,
    )


def _feats_configs(cfg: PermutationConfig):
    agnostic = LatentFeatsConfig(
        cfg.model, cfg.features, cfg.test_features, cfg.vision_features,
        cfg.lang_features, verbose=False,
    )
    images = LatentFeatsConfig(
        cfg.mod_specific_images_model, cfg.mod_specific_images_features,
        cfg.mod_specific_images_test_features, cfg.vision_features,
        cfg.lang_features, verbose=False,
    )
    captions = LatentFeatsConfig(
        cfg.mod_specific_captions_model, cfg.mod_specific_captions_features,
        cfg.mod_specific_captions_test_features, cfg.vision_features,
        cfg.lang_features, verbose=False,
    )
    return agnostic, images, captions


def _score_maps_from_results(results: dict) -> dict:
    if "score_maps" in results:
        return results["score_maps"]
    return artifacts.list_to_scores(results["scores"])  # reference-layout pickle


# ---------------------------------------------------------------------------
# Observed statistics
# ---------------------------------------------------------------------------


def load_per_subject_scores(cfg: PermutationConfig, return_nan_locations=False,
                            additional_imagery_scores=False):
    """Load agnostic + modality-specific results per subject/hemi (:102-178)."""
    agnostic_fc, images_fc, captions_fc = _feats_configs(cfg)
    per_subject_scores = {s: {} for s in cfg.subjects}
    per_subject_nan = {s: {} for s in cfg.subjects}
    for subject in cfg.subjects:
        for hemi in cfg.hemis:
            res_a = artifacts.load_pickle(
                _results_path(cfg, agnostic_fc, hemi, subject, MODALITY_AGNOSTIC)
            )
            nan_locations = np.asarray(res_a["nan_locations"])
            per_subject_nan[subject][hemi] = nan_locations
            scores_a = _score_maps_from_results(res_a)

            def load_optional(fc, mode):
                path = _results_path(cfg, fc, hemi, subject, mode)
                if os.path.isfile(path):
                    return _score_maps_from_results(artifacts.load_pickle(path))
                print(f"Missing modality-specific results: {path}")
                return None

            scores_i = load_optional(images_fc, MODALITY_SPECIFIC_IMAGES)
            scores_c = load_optional(captions_fc, MODALITY_SPECIFIC_CAPTIONS)
            per_subject_scores[subject][hemi] = process_scores(
                scores_a, scores_c, scores_i, nan_locations, additional_imagery_scores
            )
    if return_nan_locations:
        return per_subject_scores, per_subject_nan
    return per_subject_scores


def _chance(metric):
    return M.CHANCE_VALUES[metric]


def calc_t_values(per_subject_scores: dict, subjects, hemis=HEMIS, device=None) -> dict:
    """Observed t-maps + composites per hemi (parity: :261-293), float32 on
    ``device`` (``None`` = cuda); returns host numpy arrays."""
    device = resolve_device(device)
    t_values = {h: {} for h in hemis}
    for hemi in hemis:
        maps = {}
        for metric in S.T_VAL_METRICS:
            data = np.stack([per_subject_scores[s][hemi][metric] for s in subjects])
            maps[metric] = S.t_map(data.astype(np.float32), _chance(metric), device=device)
        t_values[hemi] = {k: v.cpu().numpy() for k, v in S.composite_t_maps(maps).items()}
    return t_values


# ---------------------------------------------------------------------------
# Null distribution
# ---------------------------------------------------------------------------


def assemble_null_scores(cfg: PermutationConfig, subject: str, hemi: str) -> dict:
    """Per-subject null score maps {analysis_metric: [P_within, V]}, read
    from the per-run null npz (searchlight driver output)."""
    agnostic_fc, images_fc, captions_fc = _feats_configs(cfg)

    def load_null(fc, mode):
        res_dir = os.path.dirname(_results_path(cfg, fc, hemi, subject, mode))
        path = os.path.join(res_dir, "null_distr.npz")
        if not os.path.isfile(path):
            raise RuntimeError(f"No null distribution found: {path}")
        return artifacts.load_null_scores_npz(path)  # {metric: [V', P]}

    null_a = load_null(agnostic_fc, MODALITY_AGNOSTIC)
    null_i = load_null(images_fc, MODALITY_SPECIFIC_IMAGES)
    null_c = load_null(captions_fc, MODALITY_SPECIFIC_CAPTIONS)

    res_a = artifacts.load_pickle(
        _results_path(cfg, agnostic_fc, hemi, subject, MODALITY_AGNOSTIC)
    )
    nan_locations = np.asarray(res_a["nan_locations"])

    # process_scores over the [V', P] arrays: scatter handles trailing axes
    maps = process_scores(null_a, null_c, null_i, nan_locations)
    # -> {metric: [V, P]}; transpose to [P, V]
    return {k: np.ascontiguousarray(v.T.astype(np.float32)) for k, v in maps.items()}


def _stacked_null_scores(cfg: PermutationConfig, hemi: str, members, mesh=None) -> dict:
    """{metric: [S, P_within, V]} per-subject null stacks for one hemi.

    Without a mesh (or in a world of one) this process reads every subject
    and returns numpy stacks.  With a mesh each rank reads only its subjects
    (``host_shard_bounds`` over the subject list) and one all_reduce per
    metric gives every rank the union as a tensor on its device
    (``replicate_host_filled``).  A rank that owns no subject learns the fill
    shape from rank 0, which always owns subject 0.
    """
    if mesh is None or mesh.size == 1:
        subj_nulls = [assemble_null_scores(cfg, s, hemi) for s in cfg.subjects]
        return {m: np.stack([sn[m] for sn in subj_nulls]) for m in members}
    n_subj = len(cfg.subjects)
    lo, hi = host_shard_bounds(n_subj, mesh.rank, mesh.size)
    owned = {s: assemble_null_scores(cfg, cfg.subjects[s], hemi) for s in range(lo, hi)}
    shape = torch.zeros(2, dtype=torch.int64, device=mesh.device)
    if owned:
        shape[:] = torch.as_tensor(next(iter(owned.values()))[members[0]].shape)
    torch.distributed.broadcast(shape, src=0)
    p_within, v = shape.tolist()
    out = {}
    for metric in members:
        fill = np.zeros((n_subj, p_within, v), np.float32)
        for s, maps in owned.items():
            fill[s] = maps[metric]
        out[metric] = replicate_host_filled(fill, mesh)
    return out


def _max_ignoring_nan(maps: np.ndarray) -> np.ndarray:
    return np.nanmax(np.where(np.isnan(maps), -np.inf, maps), axis=1)


def null_max_tfce_statistics(cfg: PermutationConfig, mesh=None) -> dict:
    """Group-level null: sample permutations, t-maps on the device, native TFCE.

    Returns {"null_max": [P_group] max TFCE across hemis} and caches it to
    <results>/null_max<hparams>.npz (written atomically: a killed run never
    leaves a truncated file that poisons the cache).  With ``mesh`` the
    permutations of each chunk are split over the ranks (see the module
    docstring); every rank returns the same ``null_max`` and rank 0 writes.
    """
    out_dir = permutation_results_dir(cfg)
    os.makedirs(out_dir, exist_ok=True)
    cache = os.path.join(out_dir, f"null_max{get_hparam_suffix(cfg)}.npz")
    if os.path.isfile(cache):
        z = np.load(cache)
        return {"null_max": z["null_max"]}

    device = mesh.device if mesh is not None else resolve_device(cfg.device)
    members = S.COMPOSITE_METRICS.get(cfg.metric, [cfg.metric])
    popmeans = [_chance(m) for m in members]
    n_group = cfg.n_permutations_group_level
    null_max = np.full(n_group, -np.inf, dtype=np.float64)
    for hemi in cfg.hemis:
        stacks = _stacked_null_scores(cfg, hemi, members, mesh)
        p_within = stacks[members[0]].shape[1]
        perms = S.group_permutations(p_within, len(cfg.subjects), n_group)
        scores = [torch.as_tensor(stacks.pop(m), device=device) for m in members]
        edges, lengths = cfg.edges_by_hemi[hemi]
        hemi_max = np.empty(n_group, dtype=np.float64)
        kept = []
        # one pinned host buffer for every chunk: a pageable copy of a fresh
        # array is several times slower (PERF.md, phase stats)
        host = torch.empty((min(cfg.null_chunk, n_group), scores[0].shape[-1]),
                           dtype=torch.float32, pin_memory=device.type == "cuda")
        for start, t_min in S.null_min_t_sweep(scores, perms, popmeans, cfg.null_chunk, mesh):
            maps = host[:len(t_min)].copy_(t_min).numpy()
            tfce_chunk = T.tfce_map(maps, edges, lengths,
                                    h=cfg.tfce_h, e=cfg.tfce_e, dh=cfg.tfce_dh)
            hemi_max[start:start + len(tfce_chunk)] = _max_ignoring_nan(tfce_chunk)
            if cfg.keep_null_maps:
                kept.append(tfce_chunk)
        del scores, host
        if cfg.keep_null_maps and is_writer(mesh):
            np.savez_compressed(
                os.path.join(out_dir, f"tfce_null_maps_{hemi}{get_hparam_suffix(cfg)}.npz"),
                tfce=np.concatenate(kept),
            )
        null_max = np.maximum(null_max, hemi_max)

    if is_writer(mesh):
        tmp = cache + f".{os.getpid()}.tmp.npz"
        np.savez(tmp, null_max=null_max)
        os.replace(tmp, cache)
    return {"null_max": null_max}


# ---------------------------------------------------------------------------
# Test statistics & masks
# ---------------------------------------------------------------------------


def calc_test_statistics(cfg: PermutationConfig, mesh=None) -> dict:
    """Observed t -> TFCE -> p-values (parity: :296-346), cached per stage.

    Under a mesh every rank computes the observed maps (they are small) and
    rank 0 writes them.
    """
    device = mesh.device if mesh is not None else resolve_device(cfg.device)
    out_dir = permutation_results_dir(cfg)
    os.makedirs(out_dir, exist_ok=True)
    t_values_path = os.path.join(out_dir, "t_values.p")
    tfce_path = os.path.join(out_dir, f"tfce_values{get_hparam_suffix(cfg)}.p")
    have_t, have_tfce = os.path.isfile(t_values_path), os.path.isfile(tfce_path)
    barrier(mesh)  # every rank has looked before rank 0 writes either file

    if not have_t:
        per_subject_scores = load_per_subject_scores(cfg)
        t_values = calc_t_values(per_subject_scores, cfg.subjects, cfg.hemis, device)
        if is_writer(mesh):
            artifacts.save_pickle(t_values, t_values_path)
    else:
        t_values = artifacts.load_pickle(t_values_path)

    if not have_tfce:
        edges_by_hemi = {h: cfg.edges_by_hemi[h][0] for h in cfg.hemis}
        lengths_by_hemi = {h: cfg.edges_by_hemi[h][1] for h in cfg.hemis}
        tfce_values = T.calc_tfce_values(
            t_values, edges_by_hemi, cfg.metric, h=cfg.tfce_h, e=cfg.tfce_e,
            dh=cfg.tfce_dh, edge_lengths_by_hemi=lengths_by_hemi, hemis=cfg.hemis,
        )
        if is_writer(mesh):
            artifacts.save_pickle(tfce_values, tfce_path)
    else:
        tfce_values = artifacts.load_pickle(tfce_path)

    null = null_max_tfce_statistics(cfg, mesh)
    cutoff, null_sorted = S.significance_cutoff(null["null_max"], cfg.p_value_threshold)

    p_values = {}
    for hemi in cfg.hemis:
        obs = np.asarray(tfce_values[hemi][cfg.metric], dtype=np.float64)
        p_values[hemi] = S.p_values_from_null_max(obs, null_sorted)
        with np.errstate(invalid="ignore"):
            n_pos = int(np.nansum(p_values[hemi] > 0))
        print(f"{hemi}: {n_pos} vertices with p-values; cutoff={cutoff:.3f}")

    if is_writer(mesh):
        artifacts.save_pickle(
            p_values, os.path.join(out_dir, f"p_values{get_hparam_suffix(cfg)}.p")
        )
    return {
        "t_values": t_values,
        "tfce_values": tfce_values,
        "p_values": p_values,
        "significance_cutoff": cutoff,
        "null_max_sorted": null_sorted,
    }


def create_masks(cfg: PermutationConfig, stats: dict | None = None, mesh=None) -> dict:
    """Binary masks + gifti maps + cluster tables (cluster_analysis.py:181-228).
    Under a mesh every rank computes them and rank 0 writes the files."""
    out_dir = permutation_results_dir(cfg)
    suffix = get_hparam_suffix(cfg)
    stats = stats or calc_test_statistics(cfg, mesh)
    p_values = stats["p_values"]
    tfce_values = stats["tfce_values"]
    write = is_writer(mesh)

    maps_dir = os.path.join(out_dir, "results_maps")
    if write:
        os.makedirs(maps_dir, exist_ok=True)

    fs_names = {"left": "lh", "right": "rh"}
    masks = {}
    for hemi in cfg.hemis:
        with np.errstate(invalid="ignore"):
            log10p = np.where(
                np.isnan(p_values[hemi]), np.nan, -np.log10(p_values[hemi])
            )
        if write:
            export_to_gifti(log10p,
                            os.path.join(maps_dir, f"p_values{suffix}_{fs_names[hemi]}.gii"))
            export_to_gifti(
                np.asarray(tfce_values[hemi][cfg.metric]),
                os.path.join(maps_dir, f"tfce_values{suffix}_{fs_names[hemi]}.gii"),
            )

        if cfg.tfce_value_threshold is not None:
            vals = np.asarray(tfce_values[hemi][cfg.metric])
            with np.errstate(invalid="ignore"):
                m = (vals > cfg.tfce_value_threshold).astype(np.uint8)
        else:
            with np.errstate(invalid="ignore"):
                m = (p_values[hemi] <= cfg.p_value_threshold)
            m = np.where(np.isnan(p_values[hemi]), False, m).astype(np.uint8)
        masks[hemi] = m
        if write:
            export_to_gifti(m.astype(np.float32),
                            os.path.join(maps_dir, f"mask{suffix}_{fs_names[hemi]}.gii"))

    # cluster table over the mask (calc_clusters at threshold ~0, :105-122)
    clusters_table = []
    for hemi in cfg.hemis:
        edges, lengths = cfg.edges_by_hemi[hemi]
        res = T.calc_clusters(masks[hemi].astype(np.float32), 1e-8, edges, lengths)
        clusters = sorted(res["clusters"], key=len, reverse=True)
        t_map_h = np.asarray(stats["t_values"][hemi][cfg.metric])
        for i, cluster in enumerate(clusters[:10]):
            cl = list(cluster)
            peak = cl[int(np.nanargmax(t_map_h[cl]))]
            clusters_table.append({
                "hemi": hemi, "id": i, "size": len(cl),
                "max_t_value": float(t_map_h[peak]),
                "p_value": float(p_values[hemi][peak])
                if not np.isnan(p_values[hemi][peak]) else np.nan,
                "peak_vertex": int(peak),
            })
            print(f"Cluster {hemi}/{i}: {len(cl)} vertices | "
                  f"max t={t_map_h[peak]:.2f} | peak vertex {peak}")

    if write:
        artifacts.save_pickle(masks, os.path.join(maps_dir, f"masks{suffix}.p"))
        artifacts.save_pickle(clusters_table, os.path.join(maps_dir, f"clusters{suffix}.p"))
    return {"masks": masks, "clusters": clusters_table}


def run(cfg: PermutationConfig, mesh=None) -> dict:
    """create_null_distribution -> calc_test_statistics -> create_masks (:666-675).

    ``mesh``: a ``"v"`` mesh (``parallel/mesh.vertex_mesh``) splits the group
    null over its ranks; every rank returns the same statistics and rank 0
    writes the artifacts.
    """
    print(f"\nPermutation Testing for {cfg.metric}\n")
    stats = calc_test_statistics(cfg, mesh)
    out = create_masks(cfg, stats, mesh)
    out.update(stats)
    barrier(mesh)  # every rank returns after rank 0 has written the artifacts
    return out
