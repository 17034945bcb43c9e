"""ROI overlays: Destrieux label table, ROI contours, ROI maps, legends.

Rebuilds the reference's ROI visualization layer
(the reference's analyses/visualization/plotting_utils.py:27-36 label-name
table, :292-426 surface contours, :428-520 ROI maps) and the aparc-contour
overlay pattern every published figure uses
(searchlight_plot_results.py:37-296) on the framework's own matplotlib
renderer (viz/plotting.py) — nilearn is not a dependency here, so the
contour geometry (boundary-face identification) is computed directly from
the mesh faces.
"""

from __future__ import annotations

import numpy as np

from multimodal_decoding_tpu_torch.io.surface import SurfaceMesh
from multimodal_decoding_tpu_torch.viz.plotting import plot_surf_stat_map

# Contour colour used on all published figures (searchlight_plot_results.py:35)
CONTOUR_COLOR = "lightseagreen"

# aparc ROIs outlined per (metric-class, hemi, view) in the published figures
# (searchlight_plot_results.py:50-98).  Keyed by hemi/view only: the tables
# are identical across metrics except that right-hemisphere contours are
# drawn only for the imagery metrics.
DEFAULT_ROIS_FOR_VIEW = {
    "left": {
        "medial": ["precuneus", "isthmuscingulate", "parahippocampal"],
        "lateral": ["inferiorparietal", "supramarginal", "middletemporal", "bankssts"],
        "ventral": ["inferiortemporal", "fusiform"],
    },
    "right": {
        "medial": ["precuneus", "isthmuscingulate", "parahippocampal"],
        "lateral": ["inferiorparietal", "middletemporal", "bankssts"],
        "ventral": ["inferiortemporal", "fusiform"],
    },
}


def destrieux_label_names(path: str) -> dict:
    """Parse the Destrieux label table -> {short_name: long_name}.

    File format (reference atlas_data/destrieux.txt, parsed at
    plotting_utils.py:27-36): ``<id>, <short_name> <long descriptive name>``
    per line.
    """
    long_names = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            after_id = ", ".join(line.split(", ")[1:])
            parts = after_id.split(" ")
            long_names[parts[0]] = " ".join(parts[1:])
    return long_names


def boundary_faces(faces: np.ndarray, roi_vertices: np.ndarray) -> np.ndarray:
    """Boolean [F] mask of faces on the outer edge of an ROI.

    A face is on the contour when it touches an edge vertex of the region
    (a vertex shared by a face with exactly two in-region vertices) without
    lying fully inside the region — the same geometric definition nilearn's
    contour plotting uses (consumed at plotting_utils.py:404-416).
    """
    in_roi = np.isin(faces, roi_vertices)
    verts_per_face = in_roi.sum(axis=1)
    if np.all(verts_per_face < 2):
        raise ValueError("ROI vertices do not form a connected region on the mesh")
    edge_vertices = np.intersect1d(np.unique(faces[verts_per_face == 2]), roi_vertices)
    touches_edge = np.isin(faces, edge_vertices).sum(axis=1)
    return (touches_edge > 0) & (verts_per_face < 3)


def overlay_roi_contours(
    ax,
    mesh: SurfaceMesh,
    roi_labels: np.ndarray,
    levels,
    colors=None,
    labels=None,
    legend: bool = False,
):
    """Draw ROI contours onto an axes already rendered by plot_surf_stat_map.

    ``roi_labels`` is a [V] integer label map (e.g. Annotation.label_map());
    ``levels`` the label values to outline (plot_surf_contours_custom
    semantics, plotting_utils.py:292-426).  Returns the matplotlib figure.
    """
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt
    from matplotlib.colors import Normalize, to_rgba
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    polys = [c for c in ax.collections if isinstance(c, Poly3DCollection)]
    if not polys:
        raise ValueError("axes has no rendered surface; call plot_surf_stat_map first")
    poly = polys[0]
    face_colors = getattr(poly, "_mmd_face_colors", None)
    if face_colors is None:
        face_colors = np.array(poly.get_facecolor())
        if len(face_colors) != len(mesh.faces):
            raise ValueError("cannot recover per-face colors from the collection")
    face_colors = np.array(face_colors, copy=True)

    levels = list(levels)
    if colors is None:
        cmap = plt.get_cmap("tab20")
        norm = Normalize(vmin=0, vmax=len(levels))
        colors = [cmap(norm(i)) for i in range(len(levels))]
    else:
        colors = [to_rgba(c, alpha=1.0) for c in colors]
    if labels is None:
        labels = [None] * len(levels)
    if not (len(levels) == len(labels) == len(colors)):
        raise ValueError("levels, labels and colors must have equal length")

    roi_labels = np.asarray(roi_labels)
    patches = []
    for level, color, label in zip(levels, colors, labels):
        contour = boundary_faces(mesh.faces, np.where(roi_labels == level)[0])
        face_colors[contour] = color
        if label and legend:
            patches.append(mpatches.Patch(color=color, label=label))

    poly.set_facecolor(face_colors)
    poly._mmd_face_colors = face_colors
    fig = ax.figure
    if legend and patches:
        fig.legend(handles=patches)
    return fig


def plot_surf_roi(
    mesh: SurfaceMesh,
    roi_map: np.ndarray,
    hemi: str = "left",
    view: str = "lateral",
    cmap: str = "tab20",
    threshold: float = 1e-14,
    title: str | None = None,
    ax=None,
):
    """Categorical ROI map on the surface (plot_surf_roi_custom semantics,
    plotting_utils.py:428-520): integer region ids rendered with a
    categorical colormap; sub-threshold/NaN vertices show background."""
    roi_map = np.asarray(roi_map, dtype=np.float64)
    finite = roi_map[np.isfinite(roi_map)]
    vmin = float(finite.min()) if finite.size else 0.0
    vmax = float(finite.max()) + 1.0 if finite.size else 1.0
    return plot_surf_stat_map(
        mesh,
        roi_map,
        hemi=hemi,
        view=view,
        threshold=threshold,
        vmin=vmin,
        vmax=vmax,
        cmap=cmap,
        colorbar=False,
        title=title,
        ax=ax,
        face_reduce="median",
    )


def save_legend(legend_dict: dict, path: str) -> str:
    """Standalone ROI colour legend PNG, cropped to content
    (plotting_utils.py save_legend:331-346)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt
    from PIL import Image

    patches = [mpatches.Patch(color=c, label=lbl) for lbl, c in legend_dict.items()]
    plt.figure(figsize=(30, 10))
    plt.legend(handles=patches, ncol=2, prop={"size": 12})
    plt.gca().set_axis_off()
    plt.savefig(path, dpi=300, transparent=True)
    plt.close()
    img = Image.open(path)
    bbox = img.getbbox()
    if bbox:
        img.crop(bbox).save(path)
    return path


def contour_hook(annot_by_hemi: dict, rois_for_view: dict | None = None,
                 color: str = CONTOUR_COLOR):
    """Panel hook for plot_views_grid: overlays aparc ROI contours on every
    panel, reproducing the published-figure pattern
    (searchlight_plot_results.py:208-231).

    ``annot_by_hemi``: {hemi: io.annot.Annotation}; ``rois_for_view``:
    {hemi: {view: [roi names]}} (DEFAULT_ROIS_FOR_VIEW when None).
    """
    rois_for_view = rois_for_view or DEFAULT_ROIS_FOR_VIEW

    def hook(ax, mesh, hemi, view):
        annot = annot_by_hemi.get(hemi)
        rois = rois_for_view.get(hemi, {}).get(view, [])
        if annot is None or not rois:
            return
        names = [n.decode() if isinstance(n, bytes) else n for n in annot.names]
        label_map = annot.label_map()
        for roi in rois:
            if roi not in names:
                continue
            try:
                overlay_roi_contours(ax, mesh, label_map, [names.index(roi)],
                                     colors=[color])
            except ValueError as e:
                # a degenerate ROI (isolated vertices on this mesh) must not
                # kill the whole composite figure
                import warnings

                warnings.warn(f"skipping ROI contour '{roi}' ({hemi}/{view}): {e}",
                              stacklevel=2)

    return hook
