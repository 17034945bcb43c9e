"""Self-contained GIfTI (.gii) reader/writer.

The reference relies on nibabel for surface-beta IO
(reference data.py:448-458 load; reference utils.py:102-110
export).  This framework ships its own minimal implementation of the GIFTI
XML container (spec: https://www.nitrc.org/projects/gifti) so the data layer
has no heavyweight dependency: numpy + stdlib xml/base64/zlib only.

Supported encodings: GZipBase64Binary (default for writing), Base64Binary,
ASCII.  Supported dtypes: float32, int32, uint8 (the full set the spec
allows for NIFTI_TYPE_*).
"""

from __future__ import annotations

import base64
import zlib
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

_DTYPE_TO_NIFTI = {
    np.dtype(np.float32): "NIFTI_TYPE_FLOAT32",
    np.dtype(np.int32): "NIFTI_TYPE_INT32",
    np.dtype(np.uint8): "NIFTI_TYPE_UINT8",
}
_NIFTI_TO_DTYPE = {v: k for k, v in _DTYPE_TO_NIFTI.items()}

INTENT_NONE = "NIFTI_INTENT_NONE"
INTENT_POINTSET = "NIFTI_INTENT_POINTSET"
INTENT_TRIANGLE = "NIFTI_INTENT_TRIANGLE"


@dataclass
class GiftiDataArray:
    data: np.ndarray
    intent: str = INTENT_NONE
    encoding: str = "GZipBase64Binary"
    meta: dict = field(default_factory=dict)


@dataclass
class GiftiImage:
    darrays: list

    @property
    def data(self) -> np.ndarray:
        return self.darrays[0].data


def _decode_data(elem: ET.Element, dtype: np.dtype, shape, encoding: str, endian: str) -> np.ndarray:
    text = elem.text or ""
    if encoding == "ASCII":
        arr = np.fromstring(text, dtype=dtype, sep=" ") if hasattr(np, "fromstring") else None
        if arr is None:
            arr = np.array(text.split(), dtype=dtype)
    else:
        raw = base64.b64decode(text)
        if encoding == "GZipBase64Binary":
            raw = zlib.decompress(raw)
        elif encoding != "Base64Binary":
            raise ValueError(f"Unsupported GIFTI encoding: {encoding}")
        arr = np.frombuffer(raw, dtype=dtype)
    if endian == "BigEndian":
        arr = arr.byteswap().view(arr.dtype.newbyteorder("="))
    return arr.reshape(shape).copy()


def read_gifti(path: str) -> GiftiImage:
    tree = ET.parse(path)
    root = tree.getroot()
    darrays = []
    for da in root.iter("DataArray"):
        attrs = da.attrib
        dtype = _NIFTI_TO_DTYPE[attrs["DataType"]]
        ndim = int(attrs.get("Dimensionality", "1"))
        shape = tuple(int(attrs[f"Dim{i}"]) for i in range(ndim))
        encoding = attrs.get("Encoding", "GZipBase64Binary")
        endian = attrs.get("Endian", "LittleEndian")
        order = attrs.get("ArrayIndexingOrder", "RowMajorOrder")
        data_elem = da.find("Data")
        arr = _decode_data(data_elem, dtype, shape, encoding, endian)
        if order == "ColumnMajorOrder" and arr.ndim > 1:
            arr = np.asfortranarray(arr.reshape(shape, order="F"))
        meta = {}
        md = da.find("MetaData")
        if md is not None:
            for m in md.iter("MD"):
                name = m.findtext("Name")
                value = m.findtext("Value")
                if name is not None:
                    meta[name] = value
        darrays.append(GiftiDataArray(arr, intent=attrs.get("Intent", INTENT_NONE), meta=meta))
    return GiftiImage(darrays)


def write_gifti(path: str, arrays, intents=None) -> None:
    """Write one or more numpy arrays as a GIFTI file.

    ``arrays`` may be a single array or a list; float64 is downcast to
    float32 like the reference exporter (utils.py:103).
    """
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    if intents is None:
        intents = [INTENT_NONE] * len(arrays)

    root = ET.Element("GIFTI", {"Version": "1.0", "NumberOfDataArrays": str(len(arrays))})
    for arr, intent in zip(arrays, intents):
        arr = np.asarray(arr)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        if arr.dtype not in _DTYPE_TO_NIFTI:
            raise ValueError(f"Unsupported dtype for GIFTI: {arr.dtype}")
        attrs = {
            "Intent": intent,
            "DataType": _DTYPE_TO_NIFTI[arr.dtype],
            "ArrayIndexingOrder": "RowMajorOrder",
            "Dimensionality": str(arr.ndim),
            "Encoding": "GZipBase64Binary",
            "Endian": "LittleEndian",
            "ExternalFileName": "",
            "ExternalFileOffset": "",
        }
        for i, d in enumerate(arr.shape):
            attrs[f"Dim{i}"] = str(d)
        da = ET.SubElement(root, "DataArray", attrs)
        data = ET.SubElement(da, "Data")
        payload = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        data.text = base64.b64encode(zlib.compress(payload)).decode("ascii")

    tree = ET.ElementTree(root)
    ET.indent(tree)
    with open(path, "wb") as f:
        f.write(b'<?xml version="1.0" encoding="UTF-8"?>\n')
        f.write(b'<!DOCTYPE GIFTI SYSTEM "http://www.nitrc.org/frs/download.php/115/gifti.dtd">\n')
        tree.write(f, xml_declaration=False)


def export_to_gifti(scores: np.ndarray, path: str) -> None:
    """Float32 single-array export, reference contract (utils.py:102-110)."""
    write_gifti(path, np.asarray(scores).astype(np.float32), [INTENT_NONE])
