"""FreeSurfer ``freeview`` launcher command builders.

Copy of ``multimodal_decoding_tpu/viz/freeview.py``,
its imports pointed at the port.

Rebuild of the reference's analyses/visualization/
view_decoding_results_freeview.py:26-68: assemble the (long) freeview CLI
with surface overlays, thresholds and annotations.  Pure string assembly —
testable without FreeSurfer; execution is the caller's choice.
"""

from __future__ import annotations

import os

from multimodal_decoding_tpu_torch.config import FS_HEMI_NAMES, HEMIS


def freeview_surface_arg(
    surf_path: str,
    overlays: list,
    annot: str | None = None,
    overlay_threshold: tuple | None = None,
) -> str:
    """One ``-f surface:overlay=...:...`` argument."""
    parts = [surf_path]
    for overlay in overlays:
        parts.append(f"overlay={overlay}")
        if overlay_threshold is not None:
            lo, hi = overlay_threshold
            parts.append(f"overlay_threshold={lo},{hi}")
    if annot:
        parts.append(f"annot={annot}")
    return ":".join(parts)


def build_freeview_command(
    subjects_dir: str,
    overlays_by_hemi: dict,
    surf_name: str = "inflated",
    annot: str | None = None,
    overlay_threshold: tuple | None = None,
    trg_subject: str = "fsaverage",
    hemis=HEMIS,
) -> str:
    """Full freeview invocation over both hemispheres
    (view_decoding_results_freeview.py:26-68)."""
    args = []
    for hemi in hemis:
        surf = os.path.join(subjects_dir, trg_subject, "surf", f"{FS_HEMI_NAMES[hemi]}.{surf_name}")
        annot_path = (
            os.path.join(subjects_dir, trg_subject, "label", f"{FS_HEMI_NAMES[hemi]}.{annot}")
            if annot
            else None
        )
        args.append(
            "-f "
            + freeview_surface_arg(
                surf, overlays_by_hemi.get(hemi, []), annot_path, overlay_threshold
            )
        )
    return "freeview " + " ".join(args)
