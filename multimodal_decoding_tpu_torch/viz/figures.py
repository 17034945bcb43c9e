"""Composite result figures: TFCE-thresholded maps, method panels.

Rebuilds the figure CLIs
the reference's analyses/visualization/searchlight_plot_results.py:37-296 and
searchlight_plot_method.py:42-393 on the framework's own renderer
(viz/plotting.py): per-view/hemisphere surface grids of accuracy maps,
t-maps, TFCE maps and p-value maps, assembled into composite PNGs.
"""

from __future__ import annotations

import os

import numpy as np

from multimodal_decoding_tpu_torch.config import HEMIS
from multimodal_decoding_tpu_torch.viz.plotting import plot_views_grid

# accuracy-vs-significance calibration recorded by the reference
# (searchlight_plot_method.py:164-172): t cutoff -> min mean accuracy
T_CUTOFF_ACCURACY_CALIBRATION = {
    0.05: (2.06, 0.531),
    0.01: (3.44, 0.574),
    0.001: (6.03, 0.590),
}

# Published method-figure conventions (searchlight_plot_method.py:21-39)
DEFAULT_VIEWS = ("lateral", "medial", "ventral", "posterior")
ACC_COLORBAR_MAX = 0.8
COLORBAR_THRESHOLD_MIN = 0.5
COLORBAR_DIFFERENCE_MAX = 0.1
COLORBAR_DIFFERENCE_THRESHOLD_MIN = 0.02
CMAP = "cold_hot"
CMAP_POS_ONLY = "hot"
DEFAULT_T_VALUE_THRESH = 1.0


def method_metrics():
    """The four accuracy metrics of the published method figure
    (searchlight_plot_method.py:38-39)."""
    from multimodal_decoding_tpu_torch.ops import metrics as M

    return [
        M.ACC_IMAGES_MOD_AGNOSTIC,
        M.ACC_IMAGES_MOD_SPECIFIC_CAPTIONS,
        M.ACC_CAPTIONS_MOD_AGNOSTIC,
        M.ACC_CAPTIONS_MOD_SPECIFIC_IMAGES,
    ]


def _panel(mesh, stat, hemi, view, path, *, threshold, vmax, vmin, cmap,
           colorbar=False):
    """One cropped per-view panel PNG (the reference's plot_surf_stat_map +
    save_plot_and_crop_img unit, searchlight_plot_method.py:126-141)."""
    from multimodal_decoding_tpu_torch.viz.plotting import (
        plot_surf_stat_map,
        save_plot_and_crop_img,
    )

    fig = plot_surf_stat_map(
        mesh, stat, hemi=hemi, view=view, threshold=threshold, vmax=vmax,
        vmin=vmin, cmap=cmap, colorbar=colorbar,
    )
    save_plot_and_crop_img(fig, path)
    import matplotlib.pyplot as plt

    plt.close(fig)
    return path


def plot_acc_score_panels(mesh_by_hemi, per_subject_scores, subjects, out_dir,
                          views=DEFAULT_VIEWS, metrics=None):
    """Subject-averaged accuracy panels per metric/view/hemi + colorbar crop.

    Conventions (searchlight_plot_method.py:160-216): accuracy metrics
    (chance 0.5) threshold at 0.5, vmin 0.5, vmax 0.8, 'hot'; difference
    metrics (chance 0) threshold at 0.02, vmax 0.1, symmetric 'cold_hot'.
    """
    from multimodal_decoding_tpu_torch.ops.metrics import CHANCE_VALUES

    metrics = metrics or method_metrics()
    panel_dir = os.path.join(out_dir, "tmp", "acc_scores")
    os.makedirs(panel_dir, exist_ok=True)
    written = []
    for metric in metrics:
        is_acc = CHANCE_VALUES[metric] == 0.5
        kw = dict(
            threshold=COLORBAR_THRESHOLD_MIN if is_acc
            else COLORBAR_DIFFERENCE_THRESHOLD_MIN,
            vmax=ACC_COLORBAR_MAX if is_acc else COLORBAR_DIFFERENCE_MAX,
            vmin=0.5 if is_acc else None,
            cmap=CMAP_POS_ONLY if is_acc else CMAP,
        )
        groups = {
            hemi: np.nanmean(
                np.stack([np.asarray(per_subject_scores[s][hemi][metric])
                          for s in subjects]), axis=0,
            )
            for hemi in HEMIS
        }
        for hemi in HEMIS:
            for view in views:
                written.append(_panel(
                    mesh_by_hemi[hemi], groups[hemi], hemi, view,
                    os.path.join(panel_dir, f"{metric}_{view}_{hemi}.png"), **kw,
                ))
        # colorbar plot (first hemi/view, colorbar=True, cropped)
        written.append(_panel(
            mesh_by_hemi[HEMIS[0]], groups[HEMIS[0]], HEMIS[0], views[0],
            os.path.join(panel_dir, f"colorbar_{metric}.png"),
            colorbar=True, **kw,
        ))
    return written


def plot_test_statistic_panels(mesh_by_hemi, t_values, tfce_values, metric,
                               significance_cutoff, out_dir,
                               views=DEFAULT_VIEWS):
    """t-map and TFCE-map panels with the published thresholds/colorbars.

    Conventions (searchlight_plot_method.py:105-158): t panels threshold at
    DEFAULT_T_VALUE_THRESH with vmin 0; TFCE panels threshold AND floor at
    the permutation significance cutoff; positive-only 'hot'; cbar_max fixed
    by the first panel of each statistic.
    """
    written = []
    for stat_name, maps in (("t-values", t_values), ("tfce-values", tfce_values)):
        panel_dir = os.path.join(out_dir, "tmp", stat_name)
        os.makedirs(panel_dir, exist_ok=True)
        threshold = (DEFAULT_T_VALUE_THRESH if stat_name == "t-values"
                     else significance_cutoff)
        vmin = 0.0 if stat_name == "t-values" else significance_cutoff
        cbar_max = None
        for view in views:
            for hemi in HEMIS:
                stat = np.asarray(maps[hemi][metric], dtype=np.float64)
                if cbar_max is None:
                    cbar_max = float(np.nanmax(stat))
                written.append(_panel(
                    mesh_by_hemi[hemi], stat, hemi, view,
                    os.path.join(panel_dir, f"{metric}_{view}_{hemi}.png"),
                    threshold=threshold, vmax=cbar_max, vmin=vmin,
                    cmap=CMAP_POS_ONLY,
                ))
        written.append(_panel(
            mesh_by_hemi[HEMIS[0]],
            np.asarray(maps[HEMIS[0]][metric], dtype=np.float64),
            HEMIS[0], views[0],
            os.path.join(panel_dir, f"colorbar_{metric}.png"),
            colorbar=True, threshold=threshold, vmax=cbar_max, vmin=vmin,
            cmap=CMAP_POS_ONLY,
        ))
    return written


def plot_p_value_panels(mesh_by_hemi, p_values, p_value_threshold, out_dir,
                        views=DEFAULT_VIEWS):
    """-log10(p) panels thresholded at -log10(p_threshold), global vmax
    across both hemispheres (searchlight_plot_method.py:222-268)."""
    panel_dir = os.path.join(out_dir, "tmp", "p_values")
    os.makedirs(panel_dir, exist_ok=True)
    with np.errstate(invalid="ignore"):
        logp = {
            h: np.where(np.isnan(p_values[h]), np.nan,
                        -np.log10(np.asarray(p_values[h], dtype=np.float64)))
            for h in HEMIS
        }
    vmax = float(np.nanmax(np.concatenate([logp[h] for h in HEMIS])))
    written = []
    for view in views:
        for hemi in HEMIS:
            written.append(_panel(
                mesh_by_hemi[hemi], logp[hemi], hemi, view,
                os.path.join(panel_dir, f"{view}_{hemi}.png"),
                threshold=-np.log10(p_value_threshold), vmax=vmax, vmin=0.0,
                cmap=CMAP_POS_ONLY,
            ))
    written.append(_panel(
        mesh_by_hemi[HEMIS[0]], logp[HEMIS[0]], HEMIS[0], views[0],
        os.path.join(panel_dir, "colorbar.png"),
        colorbar=True, threshold=-np.log10(p_value_threshold), vmax=vmax,
        vmin=0.0, cmap=CMAP_POS_ONLY,
    ))
    return written


def append_images(images, horizontally=True, padding=0):
    """PIL image concatenation (utils.py:67-85 parity): transparent gutter,
    top/left alignment."""
    from PIL import Image

    w = [im.size[0] for im in images]
    h = [im.size[1] for im in images]
    if horizontally:
        size = (sum(w) + padding * (len(images) - 1), max(h))
    else:
        size = (max(w), sum(h) + padding * (len(images) - 1))
    out = Image.new("RGBA", size, (255, 255, 255, 0))
    offset = 0
    for im in images:
        if horizontally:
            out.paste(im, (offset, 0))
            offset += im.size[0] + padding
        else:
            out.paste(im, (0, offset))
            offset += im.size[1] + padding
    return out


def create_method_composite(out_dir, metric, metrics=None) -> str:
    """Assemble the published method figure from the panel tree
    (create_composite_image, searchlight_plot_method.py:270-306): the
    significance-thresholded lateral-left TFCE panel with its colorbar on
    top of a 2x2 grid of the four accuracy-metric lateral-left panels."""
    from PIL import Image

    metrics = metrics or method_metrics()
    tfce_dir = os.path.join(out_dir, "tmp", "tfce-values")
    tfce_img = Image.open(os.path.join(tfce_dir, f"{metric}_lateral_left.png"))
    cbar = Image.open(os.path.join(tfce_dir, f"colorbar_{metric}.png"))
    cbar = cbar.resize((max(1, int(cbar.size[0] / 1.2)),
                        max(1, int(cbar.size[1] / 1.2))))
    tfce_img = tfce_img.resize((int(tfce_img.size[0] * 1.1),
                                int(tfce_img.size[1] * 1.1)))
    tfce_img = append_images([cbar, tfce_img], padding=150)

    acc_dir = os.path.join(out_dir, "tmp", "acc_scores")
    acc_imgs = []
    for m in metrics:
        img = Image.open(os.path.join(acc_dir, f"{m}_lateral_left.png"))
        acc_imgs.append(img.resize((max(1, int(img.size[0] / 1.2)),
                                    max(1, int(img.size[1] / 1.2)))))
    col1 = append_images(acc_imgs[:2], horizontally=False, padding=400)
    col2 = append_images(acc_imgs[2:], horizontally=False, padding=400)
    acc_grid = append_images([col1, col2], padding=400)
    full = append_images([acc_grid, tfce_img], horizontally=False, padding=300)
    path = os.path.join(out_dir, "searchlight_methods.png")
    full.save(path)
    return path


def plot_method_figures(mesh_by_hemi, per_subject_scores, t_values, tfce_values,
                        p_values, metric, significance_cutoff,
                        p_value_threshold, out_dir, views=DEFAULT_VIEWS,
                        metrics=None) -> dict:
    """All three published method-figure classes + the composite assembly
    (the full searchlight_plot_method.py run(), :310-330)."""
    subjects = list(per_subject_scores)
    written = {
        "p_values": plot_p_value_panels(
            mesh_by_hemi, p_values, p_value_threshold, out_dir, views),
        "acc_scores": plot_acc_score_panels(
            mesh_by_hemi, per_subject_scores, subjects, out_dir, views, metrics),
        "test_statistics": plot_test_statistic_panels(
            mesh_by_hemi, t_values, tfce_values, metric, significance_cutoff,
            out_dir, views),
    }
    written["composite"] = create_method_composite(out_dir, metric, metrics)
    return written


def plot_tfce_thresholded_results(
    mesh_by_hemi: dict,
    t_values: dict,
    tfce_values: dict,
    metric: str,
    tfce_cutoff: float,
    out_dir: str,
    views=("lateral", "medial"),
    vmax=None,
    annot_by_hemi: dict | None = None,
    rois_for_view: dict | None = None,
) -> str:
    """t-map masked to TFCE-significant vertices, composite grid
    (searchlight_plot_results.py:37-296 pattern).

    With ``annot_by_hemi`` ({hemi: io.annot.Annotation}, aparc), the panels
    carry ROI contour overlays like every published figure
    (searchlight_plot_results.py:208-231); ``rois_for_view`` overrides
    viz.roi.DEFAULT_ROIS_FOR_VIEW.
    """
    stat = {}
    for hemi in HEMIS:
        t = np.array(t_values[hemi][metric], dtype=np.float64)
        tf = np.asarray(tfce_values[hemi][metric])
        t[~(tf > tfce_cutoff)] = np.nan
        stat[hemi] = t
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{metric}_tfce_thresholded.png")
    hook = None
    if annot_by_hemi is not None:
        from multimodal_decoding_tpu_torch.viz.roi import contour_hook

        hook = contour_hook(annot_by_hemi, rois_for_view)
    plot_views_grid(mesh_by_hemi, stat, views=views, vmax=vmax, out_path=out_path,
                    title=f"{metric} (TFCE > {tfce_cutoff:.2f})", panel_hook=hook)
    return out_path


def plot_tfce_composite(
    mesh_by_hemi: dict,
    tfce_values: dict,
    metric: str,
    significance_cutoff: float,
    out_dir: str,
    annot_by_hemi: dict | None = None,
    rois_for_view: dict | None = None,
    views=("lateral", "medial", "ventral"),
) -> str:
    """The published-figure class: TFCE values thresholded at the
    permutation significance cutoff, positive-only 'hot' colormap, aparc ROI
    contours per view/hemi (searchlight_plot_results.py:103-231 semantics:
    result_values = tfce maps, threshold = calc_significance_cutoff,
    cmap=CMAP_POS_ONLY='hot', cbar_min=0, cbar_max=max across hemis)."""
    stat = {h: np.asarray(tfce_values[h][metric], dtype=np.float64) for h in HEMIS}
    vmax = float(np.nanmax(np.concatenate([stat[h] for h in HEMIS])))
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{metric}_tfce_composite.png")
    hook = None
    if annot_by_hemi is not None:
        from multimodal_decoding_tpu_torch.viz.roi import contour_hook

        hook = contour_hook(annot_by_hemi, rois_for_view)
    plot_views_grid(
        mesh_by_hemi, stat, views=views, threshold=significance_cutoff,
        vmax=vmax, vmin=0.0, cmap="hot", out_path=out_path,
        title=f"{metric} (TFCE, p-cutoff {significance_cutoff:.1f})",
        panel_hook=hook,
    )
    return out_path


def plot_method_panels(
    mesh_by_hemi: dict,
    per_subject_scores: dict,
    t_values: dict,
    tfce_values: dict,
    p_values: dict,
    metric: str,
    out_dir: str,
) -> list:
    """Method-figure family: per-subject accuracy grids, group mean, t/TFCE/p
    maps (searchlight_plot_method.py:42-393 pattern)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []

    subjects = list(per_subject_scores)
    for subject in subjects:
        stat = {h: np.asarray(per_subject_scores[subject][h][metric]) for h in HEMIS}
        path = os.path.join(out_dir, f"acc_{metric}_{subject}.png")
        plot_views_grid(mesh_by_hemi, stat, out_path=path, title=f"{subject} {metric}")
        written.append(path)

    group = {
        h: np.nanmean(
            np.stack([np.asarray(per_subject_scores[s][h][metric]) for s in subjects]), axis=0
        )
        for h in HEMIS
    }
    path = os.path.join(out_dir, f"acc_{metric}_group_mean.png")
    plot_views_grid(mesh_by_hemi, group, out_path=path, title=f"group mean {metric}")
    written.append(path)

    for name, maps in (("t", t_values), ("tfce", tfce_values)):
        stat = {h: np.asarray(maps[h][metric]) for h in HEMIS}
        path = os.path.join(out_dir, f"{name}_{metric}.png")
        plot_views_grid(mesh_by_hemi, stat, out_path=path, title=f"{name} {metric}")
        written.append(path)

    with np.errstate(invalid="ignore"):
        logp = {
            h: np.where(np.isnan(p_values[h]), np.nan, -np.log10(p_values[h])) for h in HEMIS
        }
    path = os.path.join(out_dir, f"p_{metric}.png")
    plot_views_grid(mesh_by_hemi, logp, out_path=path, title=f"-log10 p {metric}")
    written.append(path)
    return written


def tfce_map_correlations(tfce_values: dict, metrics: list, hemis=HEMIS) -> np.ndarray:
    """Cross-metric Pearson correlation of TFCE maps
    (plot_correlation_imagery_mod_agnostic_regions.py:20-69 semantics)."""
    vecs = []
    for metric in metrics:
        v = np.concatenate([np.asarray(tfce_values[h][metric], dtype=np.float64) for h in hemis])
        vecs.append(v)
    stacked = np.stack(vecs)
    ok = ~np.any(np.isnan(stacked), axis=0)
    return np.corrcoef(stacked[:, ok])
