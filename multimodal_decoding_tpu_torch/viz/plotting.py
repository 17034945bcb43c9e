"""Surface stat-map plotting with pure matplotlib (no nilearn dependency).

Rebuild of the reference's customised nilearn surface rendering
(the reference's analyses/visualization/plotting_utils.py:55-289): render a
per-vertex stat map on a triangular mesh from canonical anatomical views,
with background shading (sulcal-depth analogue from mesh curvature),
thresholding, and the pairwise-accuracy-aware colorbar behaviour.

nilearn is not bundled in this environment, so the renderer rasterises
triangles directly with matplotlib's Poly3DCollection — same output class
(matplotlib figure/PNG) as the reference.
"""

from __future__ import annotations

import numpy as np

from multimodal_decoding_tpu_torch.io.surface import SurfaceMesh

VIEWS = {
    # (elev, azim) per (hemi, view) like nilearn's plot_surf defaults
    ("left", "lateral"): (0, 180),
    ("left", "medial"): (0, 0),
    ("right", "lateral"): (0, 0),
    ("right", "medial"): (0, 180),
    ("left", "ventral"): (270, 0),
    ("right", "ventral"): (270, 0),
    ("left", "posterior"): (0, 90),
    ("right", "posterior"): (0, 90),
    ("left", "anterior"): (0, 270),
    ("right", "anterior"): (0, 270),
    ("left", "dorsal"): (90, 0),
    ("right", "dorsal"): (90, 0),
}


def vertex_normals(mesh: SurfaceMesh) -> np.ndarray:
    """Area-weighted vertex normals (shading basis)."""
    c, f = mesh.coordinates.astype(np.float64), mesh.faces
    fn = np.cross(c[f[:, 1]] - c[f[:, 0]], c[f[:, 2]] - c[f[:, 0]])
    vn = np.zeros_like(c)
    for i in range(3):
        np.add.at(vn, f[:, i], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    norm[norm == 0] = 1
    return vn / norm


def plot_surf_stat_map(
    mesh: SurfaceMesh,
    stat_map: np.ndarray,
    hemi: str = "left",
    view: str = "lateral",
    threshold: float | None = None,
    vmax: float | None = None,
    vmin: float | None = None,
    cmap: str = "cold_hot",
    bg_darkness: float = 0.5,
    colorbar: bool = True,
    title: str | None = None,
    ax=None,
    face_reduce: str = "mean",
):
    """Render a stat map on the mesh (plot_surf_stat_map_custom parity,
    plotting_utils.py:253-289).

    Sub-threshold / NaN vertices show the shaded background surface.  Returns
    the matplotlib figure.
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    stat_map = np.asarray(stat_map, dtype=np.float64)
    faces = mesh.faces
    coords = mesh.coordinates

    # face values: mean of vertex values (nilearn's stat-map face shading);
    # median for categorical ROI maps (plot_surf_roi_custom's avg_method,
    # plotting_utils.py:455-456)
    reduce_fn = np.nanmedian if face_reduce == "median" else np.nanmean
    face_vals = reduce_fn(stat_map[faces], axis=1)

    if vmax is None:
        vmax = np.nanmax(np.abs(face_vals)) if np.any(np.isfinite(face_vals)) else 1.0
    if vmin is None:
        vmin = -vmax if cmap == "cold_hot" else np.nanmin(face_vals)

    cmap_obj = plt.get_cmap("coolwarm" if cmap == "cold_hot" else cmap)
    normed = (face_vals - vmin) / max(vmax - vmin, 1e-12)
    colors = cmap_obj(np.clip(normed, 0, 1))

    # background shading from normals (sulci/gyri cue)
    light = np.array([0.0, 0.0, 1.0])
    vn = vertex_normals(mesh)
    shade = 0.5 + 0.5 * np.abs(vn @ light)
    face_shade = shade[faces].mean(axis=1)
    bg_gray = (1 - bg_darkness) + bg_darkness * face_shade

    masked = ~np.isfinite(face_vals)
    if threshold is not None:
        masked |= np.abs(face_vals) < threshold
    colors[masked] = np.stack([bg_gray[masked]] * 3 + [np.ones(masked.sum())], axis=1)

    if ax is None:
        fig = plt.figure(figsize=(6, 5))
        ax = fig.add_subplot(111, projection="3d")
    else:
        fig = ax.figure

    tris = coords[faces]
    poly = Poly3DCollection(tris, facecolors=colors, linewidths=0)
    # per-face colour record for ROI contour overlays (viz/roi.py)
    poly._mmd_face_colors = colors
    ax.add_collection3d(poly)
    span = coords.max(axis=0) - coords.min(axis=0)
    mid = (coords.max(axis=0) + coords.min(axis=0)) / 2
    r = span.max() / 2
    ax.set_xlim(mid[0] - r, mid[0] + r)
    ax.set_ylim(mid[1] - r, mid[1] + r)
    ax.set_zlim(mid[2] - r, mid[2] + r)
    elev, azim = VIEWS.get((hemi, view), (0, 0))
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    if colorbar:
        sm = matplotlib.cm.ScalarMappable(cmap=cmap_obj)
        sm.set_clim(vmin, vmax)
        fig.colorbar(sm, ax=ax, shrink=0.6)
    return fig


def plot_views_grid(mesh_by_hemi: dict, stat_by_hemi: dict, views=("lateral", "medial"),
                    threshold=None, vmax=None, vmin=None, cmap="cold_hot",
                    out_path: str | None = None, title=None, panel_hook=None):
    """Composite hemisphere x view grid (searchlight_plot_results.py pattern).

    ``panel_hook(ax, mesh, hemi, view)`` runs after each panel renders —
    used for aparc ROI contour overlays (viz/roi.contour_hook), the
    published-figure pattern (searchlight_plot_results.py:208-231).
    """
    import matplotlib.pyplot as plt

    hemis = list(mesh_by_hemi)
    fig = plt.figure(figsize=(5 * len(views), 4 * len(hemis)))
    for i, hemi in enumerate(hemis):
        for j, view in enumerate(views):
            ax = fig.add_subplot(len(hemis), len(views), i * len(views) + j + 1,
                                 projection="3d")
            plot_surf_stat_map(
                mesh_by_hemi[hemi], stat_by_hemi[hemi], hemi=hemi, view=view,
                threshold=threshold, vmax=vmax, vmin=vmin, cmap=cmap,
                colorbar=(j == len(views) - 1), ax=ax,
            )
            if panel_hook is not None:
                panel_hook(ax, mesh_by_hemi[hemi], hemi, view)
    if title:
        fig.suptitle(title)
    if out_path:
        fig.savefig(out_path, dpi=150, bbox_inches="tight", transparent=True)
        plt.close(fig)
    return fig


def save_plot_and_crop_img(fig, path: str, crop_to_content: bool = True) -> None:
    """Save + crop to content (utils.py:88-99 parity, PIL-based)."""
    from PIL import Image

    fig.savefig(path, dpi=300, transparent=True)
    if crop_to_content:
        img = Image.open(path)
        bbox = img.getbbox()
        if bbox:
            img.crop(bbox).save(path)
