"""Result artifact helpers: score-map containers & reference-pickle interop.

The reference stores searchlight scores as a numpy object array of ~163k
per-vertex dicts (searchlight.py:149,287) — convenient for joblib, terrible
for tensors.  This framework's canonical form is a dict-of-arrays
{metric: [V]}; these converters keep result pickles interchangeable with
reference consumers (searchlight_permutation_testing.py:63 indexes
``score[metric]`` per element).
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from multimodal_decoding_tpu_torch.utils import profiling


def scores_to_list(scores: dict) -> np.ndarray:
    """{metric: [V]} -> object array of V per-vertex dicts (reference layout)."""
    metrics = list(scores.keys())
    v = len(scores[metrics[0]])
    out = np.empty(v, dtype=object)
    for i in range(v):
        out[i] = {m: scores[m][i] for m in metrics}
    return out


def list_to_scores(score_list) -> dict:
    """Object array / list of per-vertex dicts -> {metric: [V]} float arrays."""
    metrics = list(score_list[0].keys())
    return {m: np.array([s[m] for s in score_list], dtype=np.float32) for m in metrics}


def save_pickle(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_null_scores_npz(path: str, null_scores: dict) -> None:
    """Null distributions {metric: [V, P]} as one compressed npz.

    Replaces the reference's per-vertex pickle files (searchlight.py:79 —
    ~327k files per run) with a single artifact.

    The file is the npz ``np.savez_compressed`` writes, at the same path: a
    zip archive with one deflated member ``<metric>.npy`` per metric, whose
    payload is the ``.npy`` header and the bytes of the float32 array, so
    ``np.load`` reads it as before.  Only the deflate streams differ: each
    payload is cut into ``_CHUNK_BYTES`` chunks, each deflated at level 6
    (zlib's default, which ``np.savez_compressed`` uses) by a compressor of
    its own, every chunk but a member's last ending in a sync flush, so that
    a member's chunks joined are one raw deflate stream.  The chunks of all
    members and each member's CRC-32 are computed on one pool of as many
    threads as the process may run on (``os.sched_getaffinity``), at most
    one a chunk; zlib releases the GIL.  A member of one chunk is deflated
    whole, into the plain serial stream.  The zip container (local headers,
    central directory, end record) is written here without zip64 fields:
    payloads that total ``_ZIP32_LIMIT`` bytes or more go to
    ``np.savez_compressed`` as a whole, which writes zip64.  Counter
    ``mdt.artifacts.deflate_chunks``: the chunks a call deflated.
    """
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays = {k: np.asarray(v, np.float32) for k, v in null_scores.items()}
    payloads = {k + ".npy": _npy_payload(a) for k, a in arrays.items()}
    if sum(len(h) + len(d) for h, d in payloads.values()) >= _ZIP32_LIMIT:
        np.savez_compressed(path, **arrays)
        return
    chunks = {name: list(_payload_chunks(h, d)) for name, (h, d) in payloads.items()}
    n_chunks = sum(map(len, chunks.values()))
    with ThreadPoolExecutor(min(len(os.sched_getaffinity(0)), n_chunks)) as pool:
        members = [(name, len(h) + len(d), pool.submit(_crc32, h, d),
                    [pool.submit(_deflate, parts, last) for parts, last in chunks[name]])
                   for name, (h, d) in payloads.items()]
        _write_zip(path, members)
    profiling.count("mdt.artifacts.deflate_chunks", n_chunks)


def load_null_scores_npz(path: str) -> dict:
    z = np.load(path)
    return {k: z[k] for k in z.files}


_CHUNK_BYTES = 4 << 20
# Far enough below the 4-GiB fields of a zip without zip64 that deflate's
# growth of incompressible data and the headers still fit.
_ZIP32_LIMIT = 1 << 31


def _npy_payload(a: np.ndarray) -> tuple[bytes, memoryview]:
    """The ``.npy`` header ``np.lib.format.write_array`` writes for ``a``, and
    the bytes it writes after it (a view where ``a`` is contiguous)."""
    header = io.BytesIO()
    np.lib.format.write_array_header_1_0(header, np.lib.format.header_data_from_array_1_0(a))
    if a.flags.f_contiguous and not a.flags.c_contiguous:
        a = a.T  # the header says Fortran order
    return header.getvalue(), memoryview(np.ascontiguousarray(a).reshape(-1)).cast("B")


def _payload_chunks(header: bytes, data: memoryview):
    """``header + data`` in ``_CHUNK_BYTES`` pieces: (a pair of views, whether
    the piece is the last)."""
    h, n = len(header), len(header) + len(data)
    for lo in range(0, n, _CHUNK_BYTES):
        hi = lo + _CHUNK_BYTES
        yield (header[lo:hi], data[max(lo - h, 0):max(hi - h, 0)]), hi >= n


def _deflate(parts, last: bool) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    out = [c.compress(p) for p in parts]
    out.append(c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH))
    return b"".join(out)


def _crc32(header: bytes, data: memoryview) -> int:
    return zlib.crc32(data, zlib.crc32(header))


def _write_zip(path: str, members) -> None:
    """A zip of deflated members ``(name, size, crc future, chunk futures)``,
    each written once its chunks are done, in order."""
    t = time.localtime()
    stamp = struct.pack("<HH", t.tm_hour << 11 | t.tm_min << 5 | t.tm_sec // 2,
                        (t.tm_year - 1980) << 9 | t.tm_mon << 5 | t.tm_mday)
    central = []
    with open(path, "wb") as f:
        for name, size, crc, chunk_futures in members:
            offset = f.tell()
            body = [c.result() for c in chunk_futures]
            raw = name.encode()
            # needs version 2.0; flags: a UTF-8 name; method 8, deflate
            fields = (struct.pack("<HHH", 20, 0x800, 8) + stamp
                      + struct.pack("<IIIHH", crc.result(), sum(map(len, body)), size, len(raw), 0))
            f.write(struct.pack("<I", 0x04034B50) + fields + raw)
            f.writelines(body)
            # made by Unix, version 2.0; no comment; disk 0; mode rw-------
            central.append(struct.pack("<IH", 0x02014B50, 3 << 8 | 20) + fields
                           + struct.pack("<HHHII", 0, 0, 0, 0o600 << 16, offset) + raw)
        start = f.tell()
        f.writelines(central)
        f.write(struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, len(central), len(central),
                            f.tell() - start, start, 0))
