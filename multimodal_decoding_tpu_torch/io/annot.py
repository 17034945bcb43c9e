"""FreeSurfer .annot (cortical parcellation) reader + ROI mask utilities.

Copy of ``multimodal_decoding_tpu/io/annot.py``,
its imports pointed at the port.

The reference ships HCP-MMP1/Destrieux annotations under atlas_data/ and
builds ROI-restricted decoders by masking vertices
(the reference's data.py:564-574 apply_mask; ROI decoding notebooks).  This
module parses the binary .annot format directly (big-endian: vertex count,
(vertex, packed-RGB label) pairs, then the embedded colortable) and derives
{hemi: mask} dicts compatible with data.preprocess.apply_mask.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class Annotation:
    labels: np.ndarray  # [V] packed-RGB annotation value per vertex
    names: list  # region names (index aligned with ctab rows)
    ctab: np.ndarray  # [n_regions, 5] RGBA + packed value

    def region_ids(self) -> dict:
        """{name: packed annot value}."""
        return {n: int(self.ctab[i, 4]) for i, n in enumerate(self.names)}

    def mask_for(self, region_names) -> np.ndarray:
        """Binary vertex mask over one or more region names."""
        ids = self.region_ids()
        wanted = {ids[n] for n in region_names}
        return np.isin(self.labels, list(wanted)).astype(np.uint8)

    def label_map(self) -> np.ndarray:
        """[V] region index (-1 = unassigned) from packed values."""
        lookup = {int(v): i for i, v in enumerate(self.ctab[:, 4])}
        out = np.full(len(self.labels), -1, dtype=np.int32)
        for packed, idx in lookup.items():
            out[self.labels == packed] = idx
        return out


def read_annot(path: str) -> Annotation:
    with open(path, "rb") as f:
        (n_vertices,) = struct.unpack(">i", f.read(4))
        data = np.frombuffer(f.read(n_vertices * 8), dtype=">i4").reshape(n_vertices, 2)
        labels = data[:, 1].astype(np.int64)

        names: list = []
        ctab = np.zeros((0, 5), dtype=np.int64)
        tag = f.read(4)
        if len(tag) == 4 and struct.unpack(">i", tag)[0] == 1:  # has colortable
            (ctab_version,) = struct.unpack(">i", f.read(4))
            if ctab_version > 0:  # old format
                n_entries = ctab_version
                (name_len,) = struct.unpack(">i", f.read(4))
                f.read(name_len)  # original filename
                rows = []
                for _ in range(n_entries):
                    (nl,) = struct.unpack(">i", f.read(4))
                    names.append(f.read(nl).rstrip(b"\x00").decode("latin-1"))
                    r, g, b, a = struct.unpack(">4i", f.read(16))
                    rows.append((r, g, b, a, r + g * 256 + b * 65536))
                ctab = np.asarray(rows, dtype=np.int64)
            else:  # version 2 format
                (n_entries,) = struct.unpack(">i", f.read(4))
                (name_len,) = struct.unpack(">i", f.read(4))
                f.read(name_len)
                (n_entries_again,) = struct.unpack(">i", f.read(4))
                rows = [None] * n_entries
                names = [""] * n_entries
                for _ in range(n_entries_again):
                    (idx,) = struct.unpack(">i", f.read(4))
                    (nl,) = struct.unpack(">i", f.read(4))
                    names[idx] = f.read(nl).rstrip(b"\x00").decode("latin-1")
                    r, g, b, a = struct.unpack(">4i", f.read(16))
                    rows[idx] = (r, g, b, a, r + g * 256 + b * 65536)
                ctab = np.asarray(rows, dtype=np.int64)
    return Annotation(labels=labels, names=names, ctab=ctab)


def write_annot(path: str, labels: np.ndarray, names: list, colors: np.ndarray) -> None:
    """Write a version-2 .annot (for tests & derived atlas export).

    ``colors``: [n_regions, 4] RGBA ints; packed values derived as FreeSurfer
    does (r + g*256 + b*65536).
    """
    labels = np.asarray(labels, dtype=np.int64)
    colors = np.asarray(colors, dtype=np.int64)
    with open(path, "wb") as f:
        f.write(struct.pack(">i", len(labels)))
        data = np.stack([np.arange(len(labels)), labels], axis=1).astype(">i4")
        f.write(data.tobytes())
        f.write(struct.pack(">i", 1))  # has colortable
        f.write(struct.pack(">i", -2))  # version 2
        f.write(struct.pack(">i", len(names)))
        fname = b"generated.ctab"
        f.write(struct.pack(">i", len(fname)))
        f.write(fname)
        f.write(struct.pack(">i", len(names)))
        for i, name in enumerate(names):
            f.write(struct.pack(">i", i))
            nb = name.encode("latin-1") + b"\x00"
            f.write(struct.pack(">i", len(nb)))
            f.write(nb)
            r, g, b, a = colors[i]
            f.write(struct.pack(">4i", int(r), int(g), int(b), int(a)))


def roi_mask_dict(annot_by_hemi: dict, region_names) -> dict:
    """{hemi: Annotation} + region names -> {hemi: [V] uint8 mask}
    (apply_mask-compatible, data.py:564-574)."""
    return {hemi: annot.mask_for(region_names) for hemi, annot in annot_by_hemi.items()}
