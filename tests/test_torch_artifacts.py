"""The null maps' npz (``io/artifacts.save_null_scores_npz``).

Each case writes one dict with the chunk size patched small, and holds the
file to the one ``np.savez_compressed`` writes from the same dict: the same
members in the same order, each decompressing to the same bytes; a zip that
``testzip`` passes; bit-equal arrays through ``np.load`` and
``load_null_scores_npz``.  Each member's deflate stream must be its payload
cut at every ``_CHUNK_BYTES``, each piece deflated at level 6 on its own and
ended by a sync flush (the last by a finish), which for a one-chunk member
is the plain serial stream; the counter ``mdt.artifacts.deflate_chunks``
counts those pieces.
"""

import struct
import zipfile
import zlib

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from multimodal_decoding_tpu_torch.io import artifacts as A
from multimodal_decoding_tpu_torch.utils import profiling as P

_HEADER = 128  # the .npy header of a float32 vector or [V, P] map, padded to 64


def _accuracies(shape, n=6, seed=0):
    """Null accuracies as the searchlight counts them: k / n around 0.5."""
    k = np.random.default_rng(seed).binomial(n, 0.5, size=shape)
    return (k / n).astype(np.float32)


def _vector(payload_bytes):
    """A float32 vector whose .npy payload is ``payload_bytes`` long."""
    n, rest = divmod(payload_bytes - _HEADER, 4)
    assert rest == 0
    return _accuracies((n,))


def _six_maps():
    maps = {"pairwise_acc_captions": _accuracies((40, 10), 4830, 1),
            "pairwise_acc_images": _accuracies((40, 10), 4830, 2),
            "pairwise_acc_imagery": _accuracies((40, 10), 6, 3),
            "pairwise_acc_imagery_whole_test_set": _accuracies((40, 10), 426, 4),
            "pairwise_acc_imagery_no_std": _accuracies((1, 10), 6, 5),
            "pairwise_acc_imagery_whole_test_set_no_std": _accuracies((0, 10), 426, 6)}
    maps["pairwise_acc_captions"][3, 4] = np.nan
    return maps


# (members, chunk bytes, payload limit for the zip without zip64)
CASES = {
    "zero_elements": ({"m": np.zeros((0, 100), np.float32)}, 64, A._ZIP32_LIMIT),
    "one_element": ({"m": np.float32([[0.5]])}, 1 << 10, A._ZIP32_LIMIT),
    "one_chunk_less_one_byte": ({"m": _vector(512)}, 513, A._ZIP32_LIMIT),
    "exactly_four_chunks": ({"m": _vector(512)}, 128, A._ZIP32_LIMIT),
    "three_chunks_plus_one_byte": ({"m": _vector(3 * 169 + 1)}, 169, A._ZIP32_LIMIT),
    "float64": ({"m": np.random.default_rng(7).random((40, 7))}, 256, A._ZIP32_LIMIT),
    "strided": ({"m": _accuracies((40, 21))[:, ::3]}, 256, A._ZIP32_LIMIT),
    "fortran_order": ({"m": np.asfortranarray(_accuracies((30, 11)))}, 256, A._ZIP32_LIMIT),
    "six_maps": (_six_maps(), 256, A._ZIP32_LIMIT),
    "zip64_to_numpy": (_six_maps(), 256, 1),
}


def _raw_stream(path, info):
    """A member's deflate stream as the file holds it."""
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        name_len, extra_len = struct.unpack("<HH", f.read(30)[26:])
        f.seek(name_len + extra_len, 1)
        return f.read(info.compress_size)


def _chunked_stream(payload, chunk):
    pieces = [payload[lo:lo + chunk] for lo in range(0, len(payload), chunk)]
    out = []
    for i, piece in enumerate(pieces):
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        last = i == len(pieces) - 1
        out.append(c.compress(piece) + c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH))
    return b"".join(out), len(pieces)


@pytest.mark.parametrize("case", list(CASES))
def test_null_npz_is_numpys_with_chunked_streams(case, tmp_path, monkeypatch):
    members, chunk, limit = CASES[case]
    monkeypatch.setattr(A, "_CHUNK_BYTES", chunk)
    monkeypatch.setattr(A, "_ZIP32_LIMIT", limit)
    path, plain = str(tmp_path / "out" / "null_distr.npz"), str(tmp_path / "plain.npz")
    np.savez_compressed(plain, **{k: np.asarray(v, np.float32) for k, v in members.items()})
    P.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        A.save_null_scores_npz(path, members)
    counted = P.summary()["counters"].get("mdt.artifacts.deflate_chunks", 0)
    P.reset()

    ours, theirs = zipfile.ZipFile(path), zipfile.ZipFile(plain)
    assert ours.testzip() is None
    assert ours.namelist() == theirs.namelist() == [k + ".npy" for k in members]
    payloads = {info.filename: theirs.read(info.filename) for info in ours.infolist()}
    to_numpy = sum(map(len, payloads.values())) >= limit
    n_chunks = 0
    for info in ours.infolist():
        payload = payloads[info.filename]
        assert ours.read(info.filename) == payload
        assert info.compress_type == zipfile.ZIP_DEFLATED
        stream, n = _chunked_stream(payload, chunk)
        n_chunks += n
        if not to_numpy:
            assert _raw_stream(path, info) == stream
    assert counted == (0 if to_numpy else n_chunks)
    if case == "one_chunk_less_one_byte":
        assert n_chunks == 1 and len(payload) == chunk - 1
    if case == "exactly_four_chunks":
        assert n_chunks == 4 and len(payload) == 4 * chunk
    if case == "three_chunks_plus_one_byte":
        assert n_chunks == 4 and len(payload) == 3 * chunk + 1

    for back in (np.load(path), A.load_null_scores_npz(path)):
        assert list(back.keys()) == list(members)
        for k, v in members.items():
            want = np.asarray(v, np.float32)
            got = back[k]
            assert got.dtype == np.float32 and got.shape == want.shape
            assert got.tobytes() == np.ascontiguousarray(want).tobytes()
