"""Port parity: the host copies (annotations, atlas sampling, cluster masks,
map exports, reporting, freeview, preprocessing, the export and ROI CLIs).

Each copy runs the JAX package's own test cases (tests/test_annot.py,
test_cluster_postproc.py, test_preprocessing.py, test_viz.py, test_cli.py)
beside the JAX module on the same inputs, and each package reads the files
the other wrote: .annot files, GIfTI maps, mask and ROI pickles, NIfTI
volumes, SPM jobs.
"""

import os
import pickle

import numpy as np
import pytest

from multimodal_decoding_tpu.decoding import cluster_postproc as JCP
from multimodal_decoding_tpu.io import annot as JA
from multimodal_decoding_tpu.io import atlas as JAT
from multimodal_decoding_tpu.io.gifti import read_gifti as j_read_gifti
from multimodal_decoding_tpu.preprocessing import beta_symlinks as JBS
from multimodal_decoding_tpu.preprocessing import events as JEV
from multimodal_decoding_tpu.preprocessing import masks as JMK
from multimodal_decoding_tpu.preprocessing import spm_design as JSPM
from multimodal_decoding_tpu.preprocessing import surface_transform as JST
from multimodal_decoding_tpu.viz import freeview as JFV
from multimodal_decoding_tpu.viz import maps as JVM
from multimodal_decoding_tpu.viz import reporting as JVR
from multimodal_decoding_tpu_torch.decoding import cluster_postproc as TCP
from multimodal_decoding_tpu_torch.io import annot as TA
from multimodal_decoding_tpu_torch.io import artifacts
from multimodal_decoding_tpu_torch.io import atlas as TAT
from multimodal_decoding_tpu_torch.io.gifti import read_gifti
from multimodal_decoding_tpu_torch.io.nifti import read_nifti, write_nifti
from multimodal_decoding_tpu_torch.preprocessing import beta_symlinks as TBS
from multimodal_decoding_tpu_torch.preprocessing import events as TEV
from multimodal_decoding_tpu_torch.preprocessing import masks as TMK
from multimodal_decoding_tpu_torch.preprocessing import spm_design as TSPM
from multimodal_decoding_tpu_torch.preprocessing import surface_transform as TST
from multimodal_decoding_tpu_torch.viz import freeview as TFV
from multimodal_decoding_tpu_torch.viz import maps as TVM
from multimodal_decoding_tpu_torch.viz import reporting as TVR

PACKAGES = {"jax": (JA, JAT, JCP, JVM), "torch": (TA, TAT, TCP, TVM)}
CROSS = [("jax", "torch"), ("torch", "jax")]


def _annot_case(rng, n=50):
    names = ["unknown", "V1", "MT"]
    colors = np.array([[0, 0, 0, 0], [20, 30, 40, 0], [100, 5, 1, 0]])
    packed = colors[:, 0] + colors[:, 1] * 256 + colors[:, 2] * 65536
    return names, colors, packed, packed[rng.randint(0, 3, size=n)]


@pytest.mark.parametrize("writer,reader", CROSS)
def test_annot_roundtrip_across_packages(tmp_path, rng, writer, reader):
    names, colors, packed, labels = _annot_case(rng)
    path = str(tmp_path / "lh.test.annot")
    PACKAGES[writer][0].write_annot(path, labels, names, colors)
    back = PACKAGES[reader][0].read_annot(path)
    np.testing.assert_array_equal(back.labels, labels)
    assert back.names == names
    np.testing.assert_array_equal(back.ctab[:, 4], packed)
    np.testing.assert_array_equal(back.mask_for(["V1"]),
                                  (labels == packed[1]).astype(np.uint8))
    np.testing.assert_array_equal(back.label_map() == 2, labels == packed[2])


def test_annot_files_are_byte_equal(tmp_path, rng):
    names, colors, _, labels = _annot_case(rng)
    JA.write_annot(str(tmp_path / "j.annot"), labels, names, colors)
    TA.write_annot(str(tmp_path / "t.annot"), labels, names, colors)
    assert (tmp_path / "j.annot").read_bytes() == (tmp_path / "t.annot").read_bytes()


def test_roi_mask_dict_matches_jax(tmp_path, rng):
    from multimodal_decoding_tpu_torch.data.preprocess import apply_mask

    names = ["unknown", "FFA"]
    colors = np.array([[0, 0, 0, 0], [10, 10, 10, 0]])
    packed = colors[:, 0] + colors[:, 1] * 256 + colors[:, 2] * 65536
    annots = {}
    for hemi in ("left", "right"):
        p = str(tmp_path / f"{hemi}.annot")
        TA.write_annot(p, packed[rng.randint(0, 2, size=20)], names, colors)
        annots[hemi] = TA.read_annot(p)
    masks = TA.roi_mask_dict(annots, ["FFA"])
    ref = JA.roi_mask_dict({h: JA.read_annot(str(tmp_path / f"{h}.annot"))
                            for h in ("left", "right")}, ["FFA"])
    assert set(masks) == set(ref) == {"left", "right"}
    for hemi in masks:
        np.testing.assert_array_equal(masks[hemi], ref[hemi])
    betas = rng.randn(3, 40).astype(np.float32)
    out = apply_mask(masks, [betas])[0]
    assert out.shape == (3, int(masks["left"].sum() + masks["right"].sum()))


@pytest.mark.parametrize("writer,reader", CROSS)
def test_combine_cluster_maps_across_packages(tmp_path, writer, reader):
    m1 = {"left": np.array([1.0, np.nan, 0.0, 2.5])}
    m2 = {"left": np.array([np.nan, 3.0, 0.0, np.nan])}
    p1, p2 = str(tmp_path / "m1.p"), str(tmp_path / "m2.p")
    artifacts.save_pickle(m1, p1)
    artifacts.save_pickle(m2, p2)
    out_path = str(tmp_path / "combined.p")
    combined = PACKAGES[writer][2].combine_cluster_maps([p1, p2], out_path, hemis=["left"])
    np.testing.assert_array_equal(combined["left"], [1.0, 1.0, 0.0, 1.0])
    ref = JCP.combine_cluster_maps([p1, p2], str(tmp_path / "ref.p"), hemis=["left"])
    np.testing.assert_array_equal(combined["left"], ref["left"])
    read = read_gifti if reader == "torch" else j_read_gifti
    np.testing.assert_array_equal(read(out_path.replace(".p", "_lh.gii")).darrays[0].data,
                                  combined["left"].astype(np.float32))
    with open(out_path, "rb") as f:
        np.testing.assert_array_equal(pickle.load(f)["left"], ref["left"])


def test_apply_manual_corrections_matches_jax():
    mask = {"left": np.array([1.0, 1.0, 1.0]), "right": np.array([1.0, 1.0])}
    out = TCP.apply_manual_corrections(mask, {"left": [0, 2]})
    ref = JCP.apply_manual_corrections(mask, {"left": [0, 2]})
    for h in mask:
        np.testing.assert_array_equal(out[h], ref[h])
    np.testing.assert_array_equal(out["left"], [0.0, 1.0, 0.0])
    np.testing.assert_array_equal(mask["left"], [1.0, 1.0, 1.0])  # input untouched


@pytest.mark.parametrize("writer,reader", CROSS)
def test_export_maps_across_packages(tmp_path, rng, writer, reader):
    v = 30
    per_subject = {s: {h: {"m": rng.rand(v)} for h in ("left", "right")}
                   for s in ("sub-01", "sub-02")}
    vm = PACKAGES[writer][3]
    written = vm.export_subject_maps(per_subject, ["m"], str(tmp_path))
    written += vm.export_average_maps(per_subject, ["m"], str(tmp_path),
                                      min_composites={"min_m": ["m"]})
    ref_written = JVM.export_subject_maps(per_subject, ["m"], str(tmp_path / "ref"))
    ref_written += JVM.export_average_maps(per_subject, ["m"], str(tmp_path / "ref"),
                                           min_composites={"min_m": ["m"]})
    assert [os.path.relpath(p, tmp_path) for p in written] == \
        [os.path.relpath(p, tmp_path / "ref") for p in ref_written]
    read = read_gifti if reader == "torch" else j_read_gifti
    for p, r in zip(written, ref_written):
        np.testing.assert_array_equal(read(p).data, j_read_gifti(r).data)
    avg = read([p for p in written if "avg/m_lh" in p][0]).data
    np.testing.assert_allclose(avg, np.mean([per_subject[s]["left"]["m"] for s in per_subject],
                                            axis=0), atol=1e-6)


def test_n_neighbors_map_and_patch_size_corr(tmp_path, rng):
    n = rng.randint(10, 100, size=50).astype(float)
    scores = 0.01 * n + rng.randn(50) * 0.001
    got = TVM.acc_vs_patch_size_correlation(scores, n)
    assert got == JVM.acc_vs_patch_size_correlation(scores, n) and got > 0.9
    nan_locations = rng.rand(60) < 0.2
    kept = rng.randint(5, 20, size=int((~nan_locations).sum()))
    p = TVM.export_n_neighbors_map(kept, nan_locations, "left", str(tmp_path / "t"))
    r = JVM.export_n_neighbors_map(kept, nan_locations, "left", str(tmp_path / "j"))
    assert os.path.basename(p) == os.path.basename(r) == "n_neighbors_lh.gii"
    np.testing.assert_array_equal(j_read_gifti(p).data, read_gifti(r).data)
    np.testing.assert_array_equal(TVM.scatter_full(kept, nan_locations),
                                  JVM.scatter_full(kept, nan_locations))


def test_results_frame_matches_jax(tmp_path, rng):
    pd = pytest.importorskip("pandas")
    rows = [
        dict(model="clip", subject="sub-01", training_mode="agnostic", features="avg",
             test_features="avg", vision_features="vision_features_cls",
             lang_features="lang_features_cls", alpha=100.0, num_voxels=10, mask=None,
             pairwise_acc_captions=0.8, pairwise_acc_images=0.7,
             predictions=rng.randn(4, 3), latents=rng.randn(4, 3),
             stimulus_types=np.array(["caption", "caption", "image", "image"])),
        dict(model="clip", subject="sub-02", training_mode="agnostic", features="lang",
             test_features="lang", vision_features="vision_features_cls",
             lang_features="lang_features_cls", alpha=10.0, num_voxels=10, mask=None,
             pairwise_acc_captions=0.6, pairwise_acc_images=0.5),
    ]
    for i, res in enumerate(rows):
        d = tmp_path / "agnostic" / f"sub-0{i + 1}" / "runstr"
        os.makedirs(d)
        with open(d / "results.p", "wb") as f:
            pickle.dump(res, f)
    df = TVR.load_results_frame(str(tmp_path))
    pd.testing.assert_frame_equal(df, JVR.load_results_frame(str(tmp_path)))
    assert set(df.metric) == {"pairwise_acc_captions", "pairwise_acc_images"}
    default_only = TVR.filter_default_features(df)
    assert set(default_only.subject) == {"sub-01"}
    pd.testing.assert_frame_equal(default_only, JVR.filter_default_features(df))
    summary = TVR.summarize(df, "pairwise_acc_captions", by=("model",))
    assert summary.loc["clip", "count"] == 2
    pd.testing.assert_frame_equal(summary, JVR.summarize(df, "pairwise_acc_captions"))
    # offline rescoring of the stored predictions runs on the asked device
    again = TVR.load_results_frame(str(tmp_path), recompute_metrics=True, device="cpu")
    ref = JVR.load_results_frame(str(tmp_path), recompute_metrics=True)
    assert set(again.metric) == set(ref.metric)
    merged = again.merge(ref, on=["path", "metric"], suffixes=("_t", "_j"))
    assert len(merged) == len(ref)
    np.testing.assert_allclose(merged.value_t, merged.value_j, atol=1e-6)


def test_atlas_volume_sampling_matches_jax():
    vol = np.zeros((10, 10, 10), dtype=np.int32)
    vol[5:, :, :] = 7
    coords = np.array([[2.0, 2.0, 2.0], [8.0, 3.0, 3.0], [-5.0, 0.0, 0.0]])
    got = TAT.sample_volume_at_vertices(vol, np.eye(4), coords)
    assert list(got) == [0, 7, 0]  # out-of-volume -> 0
    np.testing.assert_array_equal(got, JAT.sample_volume_at_vertices(vol, np.eye(4), coords))


@pytest.mark.parametrize("writer,reader", CROSS)
def test_volume_labels_to_annot_across_packages(tmp_path, writer, reader):
    vol = np.zeros((6, 6, 6), dtype=np.int32)
    vol[3:, :, :] = 42
    coords = np.array([[1.0, 1, 1], [5.0, 1, 1]])
    path = str(tmp_path / "lh.sub.annot")
    labels, names, colors = PACKAGES[writer][1].volume_labels_to_annot(
        vol, np.eye(4), coords, {42: "thalamus"}, out_path=path)
    ref = JAT.volume_labels_to_annot(vol, np.eye(4), coords, {42: "thalamus"})
    np.testing.assert_array_equal(labels, ref[0])
    assert names == ref[1]
    np.testing.assert_array_equal(colors, ref[2])
    back = PACKAGES[reader][0].read_annot(path)
    assert back.names == ["unknown", "thalamus"]
    np.testing.assert_array_equal(back.labels, labels)


def test_mutual_information_matches_jax():
    rng = np.random.RandomState(0)
    x, y = rng.randn(5000), rng.randn(5000)
    assert TAT.mutual_information(x, x) == JAT.mutual_information(x, x)
    assert TAT.mutual_information(x, y) == JAT.mutual_information(x, y)
    assert TAT.mutual_information(x, x) > 5 * TAT.mutual_information(x, y)
    assert TAT.normalized_mutual_information(x, x) == JAT.normalized_mutual_information(x, x)
    assert 0.9 < TAT.normalized_mutual_information(x, y) < 1.2


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_make_roi_mask_clis_write_equal_masks(tmp_path, rng, package, capsys):
    """Both CLIs on one pair of .annot files written by the other package."""
    from multimodal_decoding_tpu.cli import make_roi_mask as j_cli
    from multimodal_decoding_tpu_torch.cli import make_roi_mask as t_cli

    names = ["unknown", "V1"]
    colors = np.array([[0, 0, 0, 0], [10, 20, 30, 0]])
    packed = colors[:, 0] + colors[:, 1] * 256 + colors[:, 2] * 65536
    writer = JA if package == "torch" else TA
    for fs_hemi in ("lh", "rh"):
        writer.write_annot(str(tmp_path / f"{fs_hemi}.annot"),
                           packed[rng.randint(0, 2, size=30)], names, colors)
    argv = ["--annot-lh", str(tmp_path / "lh.annot"), "--annot-rh",
            str(tmp_path / "rh.annot"), "--regions", "V1", "--out"]
    t_cli.main(argv + [str(tmp_path / "t.p")])
    import sys

    old = sys.argv
    sys.argv = ["prog"] + argv + [str(tmp_path / "j.p")]
    try:
        j_cli.main()
    finally:
        sys.argv = old
    with open(tmp_path / "t.p", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "j.p", "rb") as f:
        ref = pickle.load(f)
    assert set(got) == set(ref) == {"left", "right"}
    for hemi in got:
        assert got[hemi].shape == (30,)
        np.testing.assert_array_equal(got[hemi], ref[hemi])
    t_cli.main(argv + [str(tmp_path / "x.p"), "--list-regions"])
    assert "['unknown', 'V1']" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "x.p")


# ---------------------------------------------------------------------------
# Preprocessing (tests/test_preprocessing.py's cases on both packages)
# ---------------------------------------------------------------------------


def test_beta_symlinks_on_volumes_written_by_jax(tmp_path, rng):
    from multimodal_decoding_tpu.io.nifti import write_nifti as j_write_nifti

    cases = [
        ("beta_0001.nii", "Sn(1) train_image_123456*bf(1)"),
        ("beta_0002.nii", "Sn(1) train_caption_99*bf(1)"),
        ("beta_0003.nii", "Sn(1) test_image_3862*bf(1)"),
        ("beta_0004.nii", "Sn(1) imagery_2*bf(1)"),
        ("beta_0005.nii", "Sn(1) blank*bf(1)"),
        ("beta_0006.nii", "Sn(1) one_back stuff"),  # skipped
    ]
    trees = {}
    for package in ("jax", "torch"):
        betas_dir = str(tmp_path / package / "sub-01")
        os.makedirs(os.path.join(betas_dir, "unstructured"))
        for fname, descrip in cases:
            j_write_nifti(os.path.join(betas_dir, "unstructured", fname),
                          np.full((2, 2, 2), len(fname), np.float32), descrip=descrip)
        module = TBS if package == "torch" else JBS
        assert module.create_symlinks_for_beta_files(betas_dir) == 5
        trees[package] = sorted(os.path.relpath(os.path.join(d, f), betas_dir)
                                for d, _, fs in os.walk(betas_dir) for f in fs)
    assert trees["torch"] == trees["jax"]
    root = str(tmp_path / "torch" / "sub-01")
    assert os.path.islink(os.path.join(root, "betas_train_image", "beta_123456.nii"))
    assert os.path.islink(os.path.join(root, "betas_imagery", "beta_000002.nii"))
    assert os.path.islink(os.path.join(root, "betas_blank", "beta_blank.nii"))
    assert read_nifti(os.path.join(root, "betas_test_image", "beta_003862.nii")).data.shape \
        == (2, 2, 2)


def test_parse_beta_descrip_matches_jax():
    for d in ("x train_image_42*bf(1)", "x blank*bf(1)", "unrelated", "Sn(1) imagery_3*bf(1)"):
        assert TBS.parse_beta_descrip(d) == JBS.parse_beta_descrip(d)
    assert TBS.parse_beta_descrip("x train_image_42*bf(1)") == ("train_image", 42)


@pytest.mark.parametrize("writer,reader", CROSS)
def test_gray_matter_mask_across_packages(tmp_path, rng, writer, reader):
    from multimodal_decoding_tpu.io.nifti import read_nifti as j_read_nifti

    c1 = rng.rand(4, 4, 4).astype(np.float32)
    c1[0] = 0.0
    write_nifti(str(tmp_path / "c1.nii"), c1)
    module = TMK if writer == "torch" else JMK
    mask = module.create_gray_matter_mask(str(tmp_path / "c1.nii"), str(tmp_path / "mask.nii"))
    assert mask.dtype == np.uint8
    np.testing.assert_array_equal(mask, (c1 > 0).astype(np.uint8))
    back = (read_nifti if reader == "torch" else j_read_nifti)(str(tmp_path / "mask.nii"))
    np.testing.assert_array_equal(back.data, mask)


def test_events_match_jax():
    for args in (("stimulus", "train", "image", 42), ("stimulus", "imagery", None, 2),
                 ("one_back", None, None, None), ("fixation", None, None, None)):
        assert TEV.condition_name(*args) == JEV.condition_name(*args)
    assert TEV.condition_name("fixation", None, None, None) == "blank"
    runs = [[{"onset": 1.0}, {"onset": 5.0}], [{"onset": 2.0}]]
    got = TEV.concatenated_run_onsets(runs, [100.0, 80.0])
    assert got == JEV.concatenated_run_onsets(runs, [100.0, 80.0])
    assert [e["onset"] for e in got] == [1.0, 5.0, 102.0]
    evs = ([{"trial_type": "one_back", "response": True}] * 3
           + [{"trial_type": "one_back", "response": False}]
           + [{"trial_type": "stimulus", "response": False}] * 8
           + [{"trial_type": "stimulus", "response": True}] * 2)
    assert TEV.one_back_error_rates(evs) == JEV.one_back_error_rates(evs)
    assert TEV.one_back_error_rates(evs)["false_alarm_rate"] == 0.2
    mp = np.zeros((4, 6))
    mp[1, 0] = 1.0
    mp[2, 3] = 0.01
    fd = TEV.framewise_displacement(mp)
    np.testing.assert_array_equal(fd, JEV.framewise_displacement(mp))
    assert abs(fd[2] - 1.5) < 1e-12


def test_spm_jobs_equal_and_cross_read(tmp_path):
    from scipy.io import loadmat

    evs = [
        [{"onset": 0.0, "duration": 2.0, "split": "train", "modality": "image", "stim_id": 5},
         {"onset": 4.0, "duration": 2.0, "trial_type": "one_back"}],
        [{"onset": 1.0, "duration": 2.0, "split": "test", "modality": "caption", "stim_id": 9}],
    ]
    motion = [np.zeros((10, 6)), np.ones((8, 6))]
    kw = dict(scans=["run1.nii", "run2.nii"], mask_path="mask.nii", out_dir=str(tmp_path))
    job = TSPM.make_spm_job(evs, [15.0, 12.0], motion, **kw)
    ref = JSPM.make_spm_job(evs, [15.0, 12.0], motion, **kw)
    spec, ref_spec = (j["matlabbatch"]["spm"]["stats"]["fmri_spec"] for j in (job, ref))
    assert spec["cvi"] == ref_spec["cvi"] == "AR(1)"
    np.testing.assert_array_equal(spec["sess"]["regress"]["val"],
                                  ref_spec["sess"]["regress"]["val"])
    assert [c["name"] for c in spec["sess"]["cond"]] == \
        [c["name"] for c in ref_spec["sess"]["cond"]]
    for c, r in zip(spec["sess"]["cond"], ref_spec["sess"]["cond"]):
        np.testing.assert_array_equal(c["onset"], r["onset"])
    TSPM.save_spm_job(job, str(tmp_path / "t.mat"))
    JSPM.save_spm_job(ref, str(tmp_path / "j.mat"))
    t_mat, j_mat = loadmat(str(tmp_path / "t.mat")), loadmat(str(tmp_path / "j.mat"))
    assert "matlabbatch" in t_mat
    assert repr(t_mat["matlabbatch"]) == repr(j_mat["matlabbatch"])


def test_surface_transform_and_freeview_commands_match_jax():
    assert TST.vol2surf_command("in.nii", "out.gii", "left", "sub-01") == \
        JST.vol2surf_command("in.nii", "out.gii", "left", "sub-01")
    assert TST.recon_all_command("sub-01", "nu.nii") == "recon-all -s sub-01 -i nu.nii -all"
    kw = dict(annot="aparc.annot", overlay_threshold=(0.55, 0.7))
    maps = {"left": ["acc_lh.gii"], "right": ["acc_rh.gii"]}
    cmd = TFV.build_freeview_command("/subjects", maps, **kw)
    assert cmd == JFV.build_freeview_command("/subjects", maps, **kw)
    assert "lh.inflated:overlay=acc_lh.gii:overlay_threshold=0.55,0.7:annot=" in cmd


# ---------------------------------------------------------------------------
# The export CLI on one set of searchlight outputs
# ---------------------------------------------------------------------------

SUBJECTS = ["sub-01", "sub-02"]


@pytest.fixture(scope="module")
def searchlight_outputs(tmp_path_factory):
    """The port's searchlight (CPU) for 2 subjects x 3 modes x 2 hemis."""
    from multimodal_decoding_tpu_torch import config as torch_config
    from multimodal_decoding_tpu_torch.data.features import _load_feature_pickle
    from multimodal_decoding_tpu_torch.data.synthetic import make_synthetic_dataset
    from multimodal_decoding_tpu_torch.decoding.searchlight import SearchlightConfig, run
    from multimodal_decoding_tpu_torch.io.surface import icosphere

    tmp = tmp_path_factory.mktemp("export_maps")
    mesh = icosphere(subdivisions=1, radius=50.0)
    for i, subj in enumerate(SUBJECTS):
        make_synthetic_dataset(str(tmp), subject=subj, n_train=40, n_vertices=mesh.n_vertices,
                               latent_dim=6, surface=True, beta_seed=100 + i,
                               n_nan_vertices=2)
    keys = ("FMRI_STIM_INFO_DIR", "LATENT_FEATURES_DIR", "BETAS_CACHE_DIR")
    orig = [getattr(torch_config, k) for k in keys]
    for k, v in zip(keys, (tmp / "stim_info", tmp / "nn_features", tmp / "cache")):
        setattr(torch_config, k, str(v))
    _load_feature_pickle.cache_clear()
    sl_out = str(tmp / "searchlight")
    coords = {"left": mesh.coordinates, "right": mesh.coordinates}
    for mode in ["agnostic", "images", "captions"]:
        run(SearchlightConfig(
            betas_dir=os.path.join(str(tmp), "betas", "surface"), mesh_coords=coords,
            model="clip", subjects=SUBJECTS, training_modes=[mode], n_neighbors=6,
            out_dir=sl_out, progress=False, block_size=8, device="cpu"))
    yield {"tmp": tmp, "sl_out": sl_out}
    for k, v in zip(keys, orig):
        setattr(torch_config, k, v)
    _load_feature_pickle.cache_clear()


def test_export_results_maps_clis_write_equal_maps(searchlight_outputs, monkeypatch):
    import sys

    from multimodal_decoding_tpu.cli import export_results_maps as j_cli
    from multimodal_decoding_tpu_torch.cli import export_results_maps as t_cli
    from multimodal_decoding_tpu_torch.decoding.permutation import (
        PermutationConfig,
        load_per_subject_scores,
    )

    tmp, sl_out = searchlight_outputs["tmp"], searchlight_outputs["sl_out"]
    common = ["--subjects", *SUBJECTS, "--model", "clip", "--mod-specific-images-model", "clip",
              "--mod-specific-captions-model", "clip", "--n-neighbors", "6",
              "--l2-regularization-alpha", "1.0", "--searchlight-out-dir", sl_out]
    t_cli.main(common + ["--out-dir", str(tmp / "t_maps")])
    monkeypatch.setattr(sys, "argv", ["prog", *common, "--out-dir", str(tmp / "j_maps")])
    j_cli.main()

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    written = files(tmp / "t_maps")
    assert written == files(tmp / "j_maps")
    assert any(p.startswith("avg/min_") for p in written)
    per_subject = load_per_subject_scores(PermutationConfig(
        subjects=SUBJECTS, model="clip", mod_specific_images_model="clip",
        mod_specific_captions_model="clip", n_neighbors=6, l2_regularization_alpha=1.0,
        searchlight_out_dir=sl_out))
    for rel in written:
        got = read_gifti(str(tmp / "t_maps" / rel)).data
        np.testing.assert_array_equal(got, j_read_gifti(str(tmp / "j_maps" / rel)).data)
        subject, name = rel.split(os.sep)
        if subject != "avg":  # a subject's map reads back as the map it came from
            metric, fs_hemi = name[:-len(".gii")].rsplit("_", 1)
            hemi = {"lh": "left", "rh": "right"}[fs_hemi]
            np.testing.assert_array_equal(
                got, np.asarray(per_subject[subject][hemi][metric], np.float32))
