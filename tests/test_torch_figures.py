"""Port parity: the figure stack (viz/plotting, roi, figures,
comparison_plots, cli/plot_results).

The JAX package's own cases (tests/test_viz.py, test_roi_viz.py,
test_figures_runlog.py, and the plot CLI of test_permutation.py) run on both
packages' modules with the same inputs: every PNG the port writes equals the
JAX package's pixel for pixel, and every non-figure output is equal.
"""

import os
import shutil
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from PIL import Image  # noqa: E402

from multimodal_decoding_tpu.io import annot as JA  # noqa: E402
from multimodal_decoding_tpu.io.surface import icosphere  # noqa: E402
from multimodal_decoding_tpu.viz import comparison_plots as JCP  # noqa: E402
from multimodal_decoding_tpu.viz import figures as JF  # noqa: E402
from multimodal_decoding_tpu.viz import plotting as JPL  # noqa: E402
from multimodal_decoding_tpu.viz import roi as JR  # noqa: E402
from multimodal_decoding_tpu_torch.io import annot as TA  # noqa: E402
from multimodal_decoding_tpu_torch.io import surface as TS  # noqa: E402
from multimodal_decoding_tpu_torch.viz import comparison_plots as TCP  # noqa: E402
from multimodal_decoding_tpu_torch.viz import figures as TF  # noqa: E402
from multimodal_decoding_tpu_torch.viz import plotting as TPL  # noqa: E402
from multimodal_decoding_tpu_torch.viz import roi as TR  # noqa: E402

PACKAGES = {"jax": (JPL, JR, JF, JCP, JA), "torch": (TPL, TR, TF, TCP, TA)}


def _mesh(pkg, subdivisions):
    """The same icosphere as each package's own SurfaceMesh."""
    m = icosphere(subdivisions=subdivisions)
    return m if pkg == "jax" else TS.SurfaceMesh(m.coordinates, m.faces)


def _png(path):
    return np.asarray(Image.open(path))


def _assert_same_png(a, b):
    x, y = _png(a), _png(b)
    assert x.shape == y.shape, (a, b)
    np.testing.assert_array_equal(x, y, err_msg=f"{a} != {b}")


def _fig_png(fig, path):
    fig.savefig(path, dpi=60)
    plt.close(fig)
    return path


def _both(tmp_path, case):
    """Run ``case(pkg, out_dir)`` for both packages; return their outputs."""
    out = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg
        os.makedirs(d, exist_ok=True)
        out[pkg] = case(pkg, d)
    return out["jax"], out["torch"]


def test_surface_plot_and_grid_equal_jax(tmp_path, rng):
    stat = rng.randn(42).astype(np.float32)
    stat[:5] = np.nan

    def case(pkg, d):
        PL = PACKAGES[pkg][0]
        mesh = _mesh(pkg, 1)
        single = _fig_png(PL.plot_surf_stat_map(mesh, stat, threshold=0.5), d / "one.png")
        grid = str(d / "grid.png")
        PL.plot_views_grid({"left": mesh, "right": mesh}, {"left": stat, "right": stat},
                           out_path=grid)
        normals = PL.vertex_normals(mesh)
        fig = PL.plot_surf_stat_map(mesh, stat, colorbar=False, cmap="hot")
        crop = str(d / "crop.png")
        PL.save_plot_and_crop_img(fig, crop)
        plt.close(fig)
        return single, grid, crop, normals

    ref, got = _both(tmp_path, case)
    for a, b in zip(ref[:3], got[:3]):
        _assert_same_png(a, b)
    assert os.path.getsize(got[1]) > 1000
    np.testing.assert_array_equal(got[3], ref[3])


def test_tfce_map_correlations_equal_jax(rng):
    tfce = {h: {"a": rng.rand(40), "b": rng.rand(40)} for h in ("left", "right")}
    tfce["left"]["b"][:3] = np.nan
    got = TF.tfce_map_correlations(tfce, ["a", "b"])
    np.testing.assert_array_equal(got, JF.tfce_map_correlations(tfce, ["a", "b"]))
    assert abs(got[0, 0] - 1.0) < 1e-12


def test_comparison_plots_equal_jax(tmp_path, rng, monkeypatch):
    import pandas as pd

    # seaborn bootstraps the bars' error bars from np.random.default_rng(None):
    # seed it, so both packages' calls draw the same intervals
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: default_rng(0 if seed is None else seed))

    rows = []
    for model in ("clip", "vit"):
        for subj in ("sub-01", "sub-02", "sub-03", "sub-04", "sub-05", "sub-07"):
            for metric in ("pairwise_acc_captions", "pairwise_acc_images"):
                rows.append(dict(model=model, training_mode="agnostic", subject=subj,
                                 metric=metric, value=0.5 + 0.3 * rng.rand()))
    df = pd.DataFrame(rows)
    bad = df[df.subject != "sub-07"]

    def case(pkg, d):
        CP = PACKAGES[pkg][3]
        assert CP.verify_num_datapoints(df, ["clip", "vit"], training_modes=["agnostic"]) == []
        with pytest.raises(RuntimeError, match="unexpected number of datapoints"):
            CP.verify_num_datapoints(bad, ["clip"], training_modes=["agnostic"])
        warned = CP.verify_num_datapoints(bad, ["clip"], training_modes=["agnostic"],
                                          strict=False)
        g = CP.plot_metric(df, order=["clip", "vit"], hue_order=["agnostic"])
        bar = _fig_png(g.figure, d / "bar.png")
        g = CP.plot_metric(df, kind="point", order=["clip", "vit"], hue_order=["agnostic"])
        point = _fig_png(g.figure, d / "point.png")
        out = str(d / "cmp.png")
        CP.create_result_graph(df, order=["clip", "vit"], hue_order=["agnostic"], out_path=out)
        return warned, bar, point, out

    ref, got = _both(tmp_path, case)
    assert got[0] == ref[0] and got[0]
    for a, b in zip(ref[1:], got[1:]):
        _assert_same_png(a, b)
    assert os.path.getsize(got[3]) > 1000


def test_destrieux_label_names_equal_jax(tmp_path):
    p = tmp_path / "destrieux.txt"
    p.write_text(
        "1, G_and_S_frontomargin Fronto-marginal gyrus (of Wernicke) and sulcus\n"
        "2, G_and_S_occipital_inf Inferior occipital gyrus (O3) and sulcus\n"
        "\n"
        "6, G_and_S_cingul-Ant Anterior part of the cingulate gyrus and sulcus (ACC)\n"
    )
    got = TR.destrieux_label_names(str(p))
    assert got == JR.destrieux_label_names(str(p)) and len(got) == 3


def test_boundary_faces_equal_jax():
    mesh = icosphere(subdivisions=2)
    roi = np.where(mesh.coordinates[:, 2] > 0)[0]
    got = TR.boundary_faces(mesh.faces, roi)
    np.testing.assert_array_equal(got, JR.boundary_faces(mesh.faces, roi))
    assert got.any()
    with pytest.raises(ValueError, match="form a connected region"):
        TR.boundary_faces(mesh.faces, np.array([0]))


def test_overlay_recolors_contour_faces_equal_jax(tmp_path, rng):
    stat = rng.randn(162).astype(np.float32)

    def case(pkg, d):
        PL, R = PACKAGES[pkg][:2]
        mesh = _mesh(pkg, 2)
        labels = (mesh.coordinates[:, 2] > 0).astype(np.int32)
        fig = PL.plot_surf_stat_map(mesh, stat, colorbar=False)
        ax = fig.axes[0]
        before = np.array(ax.collections[0]._mmd_face_colors, copy=True)
        R.overlay_roi_contours(ax, mesh, labels, levels=[1], colors=["lightseagreen"])
        after = np.array(ax.collections[0]._mmd_face_colors)
        return before, after, _fig_png(fig, d / "overlay.png")

    ref, got = _both(tmp_path, case)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert not np.array_equal(got[0], got[1])
    _assert_same_png(ref[2], got[2])


def test_plot_surf_roi_and_legend_equal_jax(tmp_path):
    def case(pkg, d):
        R = PACKAGES[pkg][1]
        mesh = _mesh(pkg, 1)
        roi_map = np.full(mesh.n_vertices, np.nan)
        roi_map[mesh.coordinates[:, 0] > 0] = 3
        roi_map[mesh.coordinates[:, 0] < -0.5] = 7
        roi = _fig_png(R.plot_surf_roi(mesh, roi_map), d / "roi.png")
        legend = R.save_legend({"precuneus": "lightseagreen", "fusiform": "red"},
                               str(d / "legend.png"))
        return roi, legend

    ref, got = _both(tmp_path, case)
    for a, b in zip(ref, got):
        _assert_same_png(a, b)
    assert os.path.getsize(got[1]) > 500


def _fake_aparc(pkg, mesh, names=("unknown", "precuneus", "fusiform")):
    """Annotation whose label_map() partitions the sphere by z (the JAX
    test's helper), as each package's own Annotation."""
    z = mesh.coordinates[:, 2]
    idx = np.digitize(z, np.quantile(z, [0.34, 0.67]))
    colors = np.array([[25, 5, 25], [60, 20, 220], [220, 60, 20]], dtype=np.int64)
    packed = colors[:, 0] + colors[:, 1] * 256 + colors[:, 2] * 65536
    return PACKAGES[pkg][4].Annotation(
        labels=packed[idx], names=list(names),
        ctab=np.column_stack([colors, np.zeros(3, np.int64), packed]))


def test_contour_hook_and_composite_equal_jax(tmp_path, rng):
    tfce = {h: {"m": np.abs(rng.randn(162)) * 100} for h in ("left", "right")}
    stat = rng.randn(162)

    def case(pkg, d):
        PL, R, F, _, A = PACKAGES[pkg]
        mesh = _mesh(pkg, 2)
        annot = _fake_aparc(pkg, mesh)
        composite = F.plot_tfce_composite(
            {"left": mesh, "right": mesh}, tfce, "m", significance_cutoff=50.0,
            out_dir=str(d), annot_by_hemi={"left": annot, "right": annot},
            rois_for_view={
                "left": {"lateral": ["precuneus"], "medial": ["fusiform"], "ventral": []},
                "right": {"lateral": [], "medial": ["precuneus"], "ventral": []},
            },
            views=("lateral", "medial"))
        # a written and re-read .annot drives the hook end to end
        path = str(d / "lh.aparc.annot")
        A.write_annot(path, annot.labels, annot.names, annot.ctab[:, :4])
        fig = PL.plot_surf_stat_map(mesh, stat, colorbar=False)
        R.contour_hook({"left": A.read_annot(path)},
                       {"left": {"lateral": ["precuneus", "fusiform"]}})(
            fig.axes[0], mesh, "left", "lateral")
        return composite, _fig_png(fig, d / "hooked.png")

    ref, got = _both(tmp_path, case)
    assert os.path.getsize(got[0]) > 1000
    for a, b in zip(ref, got):
        _assert_same_png(a, b)


def test_tfce_thresholded_figure_equal_jax(tmp_path, rng):
    t_values = {h: {"m": rng.randn(42) + 1} for h in ("left", "right")}
    tfce_values = {h: {"m": np.abs(rng.randn(42)) * 10} for h in ("left", "right")}

    def case(pkg, d):
        mesh = _mesh(pkg, 1)
        return PACKAGES[pkg][2].plot_tfce_thresholded_results(
            {"left": mesh, "right": mesh}, t_values, tfce_values, "m", tfce_cutoff=5.0,
            out_dir=str(d))

    ref, got = _both(tmp_path, case)
    assert os.path.getsize(got) > 1000
    _assert_same_png(ref, got)


def test_method_panels_equal_jax(tmp_path, rng):
    subjects = ["sub-01", "sub-02"]
    per_subject = {s: {h: {"m": rng.rand(42)} for h in ("left", "right")} for s in subjects}
    t_values = {h: {"m": rng.randn(42)} for h in ("left", "right")}
    tfce_values = {h: {"m": np.abs(rng.randn(42))} for h in ("left", "right")}
    p_values = {h: np.where(rng.rand(42) < 0.3, rng.rand(42) * 0.1, np.nan)
                for h in ("left", "right")}

    def case(pkg, d):
        mesh = _mesh(pkg, 1)
        return PACKAGES[pkg][2].plot_method_panels(
            {"left": mesh, "right": mesh}, per_subject, t_values, tfce_values, p_values, "m",
            str(d))

    ref, got = _both(tmp_path, case)
    assert len(got) == len(subjects) + 3 + 1
    assert [os.path.relpath(p, tmp_path / "torch") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in ref]
    for a, b in zip(ref, got):
        _assert_same_png(a, b)


def test_method_figures_equal_jax(tmp_path, rng):
    """The published method-figure classes and their composite
    (searchlight_plot_method.py:42-393) from the same maps."""
    from multimodal_decoding_tpu_torch.ops import metrics as TM

    metrics = TF.method_metrics()
    assert metrics == JF.method_metrics()
    subjects = ["sub-01", "sub-02"]
    per_subject = {s: {h: {m: 0.5 + 0.3 * rng.rand(42) for m in metrics}
                       for h in ("left", "right")} for s in subjects}
    metric = metrics[0]
    t_values = {h: {metric: rng.randn(42) + 1.5} for h in ("left", "right")}
    tfce_values = {h: {metric: np.abs(rng.randn(42)) * 10} for h in ("left", "right")}
    p_values = {h: np.where(rng.rand(42) < 0.3, rng.rand(42) * 0.1, np.nan)
                for h in ("left", "right")}
    assert TM.CHANCE_VALUES[metric] == 0.5

    def case(pkg, d):
        mesh = _mesh(pkg, 1)
        return PACKAGES[pkg][2].plot_method_figures(
            {"left": mesh, "right": mesh}, per_subject, t_values, tfce_values, p_values,
            metric, 5.0, 0.05, str(d), views=("lateral", "posterior"))

    ref, got = _both(tmp_path, case)
    files = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "torch")
                   for r, _, fs in os.walk(tmp_path / "torch") for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), tmp_path / "jax")
                           for r, _, fs in os.walk(tmp_path / "jax") for f in fs)
    for f in files:
        _assert_same_png(tmp_path / "jax" / f, tmp_path / "torch" / f)
    assert os.path.getsize(got["composite"]) > 2000


@pytest.fixture(scope="module")
def plot_cli_artifacts(tmp_path_factory):
    """Two synthetic subjects' searchlights (3 modes, nulls) on icosphere(1),
    written by the JAX package, and the meshes as FreeSurfer files."""
    from multimodal_decoding_tpu import config as jax_config
    from multimodal_decoding_tpu.data.features import _load_feature_pickle
    from multimodal_decoding_tpu.data.synthetic import make_synthetic_dataset
    from multimodal_decoding_tpu.decoding.searchlight import SearchlightConfig, run
    from multimodal_decoding_tpu_torch import config as torch_config

    tmp = tmp_path_factory.mktemp("plot_cli")
    mesh = icosphere(subdivisions=1, radius=50.0)
    subjects = ["sub-01", "sub-02"]
    for i, subj in enumerate(subjects):
        make_synthetic_dataset(str(tmp), subject=subj, n_train=40, n_vertices=mesh.n_vertices,
                               latent_dim=6, surface=True, beta_seed=300 + i)
    keys = ("FMRI_STIM_INFO_DIR", "LATENT_FEATURES_DIR", "BETAS_CACHE_DIR")
    orig = {cfg: [getattr(cfg, k) for k in keys] for cfg in (jax_config, torch_config)}
    for cfg in orig:
        for k, v in zip(keys, (tmp / "stim_info", tmp / "nn_features", tmp / "cache")):
            setattr(cfg, k, str(v))
    _load_feature_pickle.cache_clear()
    sl_out = str(tmp / "searchlight")
    for mode in ["agnostic", "images", "captions"]:
        run(SearchlightConfig(
            betas_dir=os.path.join(str(tmp), "betas", "surface"),
            mesh_coords={"left": mesh.coordinates, "right": mesh.coordinates},
            model="clip", subjects=subjects, training_modes=[mode], n_neighbors=6,
            create_null_distr=True, n_permutations_per_subject=4, out_dir=sl_out,
            progress=False, block_size=8))
    mesh_dir = tmp / "surfaces" / "fsaverage7"
    os.makedirs(mesh_dir)
    for h in ("lh", "rh"):
        TS.write_freesurfer_geometry(str(mesh_dir / f"{h}.inflated"),
                                     TS.SurfaceMesh(mesh.coordinates, mesh.faces))
    yield {"tmp": tmp, "subjects": subjects, "sl_out": sl_out,
           "mesh_dir": str(tmp / "surfaces")}
    for cfg, vals in orig.items():
        for k, v in zip(keys, vals):
            setattr(cfg, k, v)
    _load_feature_pickle.cache_clear()


def test_plot_results_cli_equal_jax(plot_cli_artifacts, monkeypatch):
    """The JAX CLI computes the statistics and draws the composites; the
    port's CLI, started on a copy of those statistics (it reads the JAX
    package's t_values.p and null_max*.npz), draws the same PNGs."""
    from multimodal_decoding_tpu.cli import plot_results as jax_cli
    from multimodal_decoding_tpu_torch.cli import plot_results as port_cli

    a = plot_cli_artifacts
    tmp = a["tmp"]
    argv = ["--subjects", *a["subjects"], "--model", "clip",
            "--mod-specific-images-model", "clip", "--mod-specific-captions-model", "clip",
            "--n-neighbors", "6", "--l2-regularization-alpha", "1.0",
            "--n-permutations-group-level", "8", "--p-value-threshold", "0.2",
            "--mesh-dir", a["mesh_dir"], "--searchlight-out-dir", a["sl_out"],
            "--figure-metrics", "mod_agnostic_and_cross", "--views", "lateral", "medial",
            "--method-figures"]
    jax_out, port_out = tmp / "jax_plots", tmp / "port_plots"
    monkeypatch.setattr(sys, "argv", ["plot_results", *argv, "--out-dir", str(jax_out)])
    jax_cli.main()
    shutil.copytree(jax_out, port_out, ignore=shutil.ignore_patterns("figures"))
    assert port_cli.get_args(argv).device == "cuda"
    written = port_cli.main([*argv, "--out-dir", str(port_out), "--device", "cpu"])
    assert written and all(str(p).startswith(str(port_out)) for p in written)
    rel = [os.path.relpath(p, port_out) for p in written]
    for r in rel:
        _assert_same_png(jax_out / r, port_out / r)
    assert len(rel) == 2 and all(r.endswith(".png") for r in rel)
    panels = sorted(os.path.relpath(os.path.join(r, f), port_out / "figures")
                    for r, _, fs in os.walk(port_out / "figures") for f in fs)
    assert any(p.startswith("tmp/acc_scores/") for p in panels)
    for p in panels:
        _assert_same_png(jax_out / "figures" / p, port_out / "figures" / p)
