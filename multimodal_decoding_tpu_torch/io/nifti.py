"""Minimal NIfTI-1 volume reader/writer (stdlib + numpy).

Covers what the data layer needs from nibabel in the reference
(reference data.py:493-503 ``nib.load(...).get_fdata()``): single-file
.nii / .nii.gz, the common datatypes, scl_slope/scl_inter scaling, and the
``descrip`` header field (used by the reference's beta-symlink stage,
preprocessing/create_symlinks_beta_files.py:28-56).
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class Nifti1Image:
    data: np.ndarray
    descrip: str = ""
    affine: np.ndarray | None = None

    def get_fdata(self) -> np.ndarray:
        return self.data.astype(np.float64)


def _open(path: str, mode: str = "rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> Nifti1Image:
    with _open(path) as f:
        hdr = f.read(348)
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        endian = "<"
        if sizeof_hdr != 348:
            endian = ">"
            if struct.unpack(">i", hdr[0:4])[0] != 348:
                raise ValueError(f"Not a NIfTI-1 file: {path}")
        dim = struct.unpack(endian + "8h", hdr[40:56])
        datatype = struct.unpack(endian + "h", hdr[70:72])[0]
        vox_offset = struct.unpack(endian + "f", hdr[108:112])[0]
        scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
        scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]
        descrip = hdr[148:228].split(b"\x00")[0].decode("latin-1")
        magic = hdr[344:348]
        if magic[:3] not in (b"n+1", b"ni1"):
            raise ValueError(f"Bad NIfTI magic in {path}: {magic!r}")

        ndim = dim[0]
        shape = tuple(dim[1 : 1 + ndim]) if ndim > 0 else ()
        dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
        f.seek(int(vox_offset))
        count = int(np.prod(shape)) if shape else 0
        raw = f.read(count * dtype.itemsize)
        arr = np.frombuffer(raw, dtype=dtype, count=count).reshape(shape, order="F")

    data = arr.astype(np.float32) if arr.dtype.kind == "f" else arr
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    return Nifti1Image(np.asarray(data), descrip=descrip)


def write_nifti(path: str, data: np.ndarray, descrip: str = "") -> None:
    data = np.asarray(data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    code = _CODES[data.dtype]

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    # pixdim: qfac + unit spacings
    struct.pack_into("<8f", hdr, 76, 1.0, *([1.0] * 7))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    hdr[148:228] = descrip.encode("latin-1")[:80].ljust(80, b"\x00")
    hdr[344:348] = b"n+1\x00"

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(np.asfortranarray(data).tobytes(order="F"))
