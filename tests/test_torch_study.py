"""Port parity: the one-command study (``decoding/study.py``).

The port's ``run_study`` runs on a small synthetic dataset on the CPU
(3 subjects, both hemispheres of icosphere(1), per-vertex alpha CV).  The
JAX package's permutation ``run`` on the study's searchlight outputs gives
the same p-maps and masks, and a rerun of the study skips every stage.
"""

import os

import numpy as np
import pytest

from multimodal_decoding_tpu import config as jax_config
from multimodal_decoding_tpu.decoding import permutation as JP
from multimodal_decoding_tpu.io.surface import edge_lengths
from multimodal_decoding_tpu_torch import config as torch_config
from multimodal_decoding_tpu_torch.data.synthetic import make_synthetic_dataset
from multimodal_decoding_tpu_torch.decoding import permutation as TP
from multimodal_decoding_tpu_torch.decoding import searchlight as TSL
from multimodal_decoding_tpu_torch.decoding.study import StudyConfig, run_study
from multimodal_decoding_tpu_torch.io.surface import icosphere

SUBJECTS = ["sub-01", "sub-02", "sub-03"]


@pytest.fixture
def study(tmp_path, monkeypatch):
    mesh = icosphere(subdivisions=1, radius=50.0)  # 42 vertices
    for i, subj in enumerate(SUBJECTS):
        make_synthetic_dataset(str(tmp_path), subject=subj, n_train=40,
                               n_vertices=mesh.n_vertices, latent_dim=6, beta_seed=10 + i,
                               n_nan_vertices=2)
    for cfg in (jax_config, torch_config):
        monkeypatch.setattr(cfg, "FMRI_STIM_INFO_DIR", str(tmp_path / "stim_info"))
        monkeypatch.setattr(cfg, "LATENT_FEATURES_DIR", str(tmp_path / "nn_features"))
        monkeypatch.setattr(cfg, "BETAS_CACHE_DIR", str(tmp_path / "cache"))
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle

    _load_feature_pickle.cache_clear()
    cfg = StudyConfig(
        betas_dir=os.path.join(str(tmp_path), "betas", "surface"),
        meshes={"left": mesh, "right": mesh}, model="clip", subjects=SUBJECTS,
        l2_regularization_alpha="cv", n_neighbors=6, n_permutations_per_subject=6,
        # the least p of 20 permutations is 1 - 19/20 = 0.05000000000000004
        n_permutations_group_level=20, p_value_threshold=0.06,
        searchlight_out_dir=str(tmp_path / "sl"), permutation_out_dir=str(tmp_path / "perm"),
        block_size=8, progress=False, device="cpu")
    yield cfg, mesh, run_study(cfg)
    _load_feature_pickle.cache_clear()


def test_study_matches_the_jax_permutation_stage_and_skips_on_rerun(study, monkeypatch,
                                                                       tmp_path):
    cfg, mesh, stats = study
    # 3 training modes x 3 subjects x 2 hemis, each at the alpha-CV path key
    assert len(stats["searchlight_outputs"]) == 3 * len(SUBJECTS) * 2
    assert all(p.endswith(os.path.join("n_neighbors_6", "alpha_cv.p"))
               for p in stats["searchlight_outputs"])
    assert os.path.isfile(os.path.join(os.path.dirname(stats["searchlight_outputs"][0]),
                                       "null_distr.npz"))
    assert os.path.isdir(os.path.join(cfg.searchlight_out_dir, ".adjacency_cache"))
    assert sum(stats["masks"][h].sum() for h in ("left", "right")) > 0  # planted signal

    pcfg = stats["permutation_config"]
    edges = edge_lengths(mesh)
    jcfg = JP.PermutationConfig(**{
        k: getattr(pcfg, k) for k in ("subjects", "model", "features",
                                       "mod_specific_images_model",
                                       "mod_specific_images_features",
                                       "mod_specific_captions_model",
                                       "mod_specific_captions_features",
                                       "l2_regularization_alpha", "resolution", "n_neighbors",
                                       "radius", "metric", "n_permutations_group_level",
                                       "p_value_threshold", "hemis", "searchlight_out_dir")},
        edges_by_hemi={"left": edges, "right": edges}, out_dir=str(tmp_path / "jax_perm"))
    ref = JP.run(jcfg)
    for hemi in ("left", "right"):
        np.testing.assert_array_equal(stats["p_values"][hemi], ref["p_values"][hemi])
        np.testing.assert_array_equal(stats["masks"][hemi], ref["masks"][hemi])
    np.testing.assert_allclose(stats["null_max_sorted"], ref["null_max_sorted"], rtol=1e-5)

    def refuse(*a, **k):
        raise AssertionError("a cached stage was recomputed")

    monkeypatch.setattr(TSL, "run_searchlight", refuse)
    monkeypatch.setattr(TP, "load_per_subject_scores", refuse)
    monkeypatch.setattr(TP, "_stacked_null_scores", refuse)
    again = run_study(cfg)
    assert again["searchlight_outputs"] == []
    for hemi in ("left", "right"):
        np.testing.assert_array_equal(again["p_values"][hemi], stats["p_values"][hemi])
        np.testing.assert_array_equal(again["masks"][hemi], stats["masks"][hemi])
