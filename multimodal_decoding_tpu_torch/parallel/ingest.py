"""Host-RAM-bounded streaming ingestion: betas npz cache -> device X_all.

Port of ``multimodal_decoding_tpu/parallel/ingest.py``.  The eager
searchlight ingestion (``decoding/searchlight.run`` ->
``data/preprocess.standardize_fmri_betas`` -> the runner's concatenate)
makes ~3x the train betas' bytes in fresh host pages at fsaverage7 scale:
the ``np.load`` copy, the NaN-column-drop copy and the concatenate copy
(~16 GB for an [8192, 163842] subject).  This module streams row chunks of
the uncompressed ``.npz`` betas cache (``data/betas.get_fmri_surface_data``
writes it with ``np.savez``, ZIP_STORED) through reused buffers, so host
memory stays O(chunk):

  pass 1  sequential float64 moment accumulation in numpy's axis-0 order:
          the statistics equal ``standardize_fmri_betas``'s bit for bit;
  pass 2  per chunk the NaN-column drop (``np.compress`` into the buffer)
          and the same in-place float32 ``(x - mean32) / scale32`` on the
          host as the eager path, then a copy into the preallocated
          ``[n_rows, V_kept]`` device tensor.

On CUDA the chunks go through two pinned host buffers, each copied to the
card asynchronously; before the host refills a buffer it waits on the CUDA
event recorded after that buffer's last copy.  ``NpzMemberReader``,
``default_chunk_rows`` and ``streamed_scaler_fit`` are copies of the JAX
package's numpy code.
"""

from __future__ import annotations

import zipfile

import numpy as np
import torch

from multimodal_decoding_tpu_torch.device import resolve_device


class NpzMemberReader:
    """Row-chunk reader over one 2-D array member of an UNCOMPRESSED .npz.

    ``np.savez`` stores members with ZIP_STORED, so a member is a plain
    .npy byte range inside the archive: after the header, rows of a
    C-order [n_rows, n_cols] array are contiguous and can be streamed
    with ``readinto`` at file-read speed into a caller-owned buffer.
    """

    def __init__(self, path: str, member: str = "betas"):
        self.path = path
        self.member = member + ".npy"
        zf = zipfile.ZipFile(path)
        try:
            info = zf.getinfo(self.member)
        except KeyError:
            raise ValueError(f"{path} has no member {self.member!r}") from None
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(
                f"{path}:{self.member} is compressed; streaming ingestion "
                "needs the uncompressed np.savez cache"
            )
        self._zf = zf
        with zf.open(self.member) as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        if len(shape) != 2 or fortran:
            raise ValueError(f"{path}:{self.member}: need a C-order 2-D array, got {shape}")
        if dtype.hasobject:
            raise ValueError("object arrays are not streamable")
        self.shape = shape
        self.dtype = dtype
        self.n_rows, self.n_cols = shape
        self._row_bytes = self.n_cols * dtype.itemsize

    def read_row(self, i: int) -> np.ndarray:
        """One row (fresh small array), used for the NaN-column mask."""
        if not 0 <= i < self.n_rows:
            raise IndexError(i)
        out = np.empty(self.n_cols, self.dtype)
        with self._zf.open(self.member) as f:
            version = np.lib.format.read_magic(f)
            (np.lib.format.read_array_header_1_0 if version == (1, 0)
             else np.lib.format.read_array_header_2_0)(f)
            # ZipExtFile.seek on a stored member re-reads from the start;
            # for row 0 (the common case: the NaN mask) this is free
            f.seek(i * self._row_bytes, 1)
            self._readinto(f, memoryview(out).cast("B"))
        return out

    @staticmethod
    def _readinto(f, mv) -> None:
        n = 0
        while n < len(mv):
            got = f.readinto(mv[n:])
            if not got:
                raise EOFError("truncated npz member")
            n += got

    def iter_row_chunks(self, chunk_rows: int, buf: np.ndarray | None = None):
        """Yield ``(row0, view)`` where view is [rows, n_cols] into ``buf``.

        The SAME buffer backs every yielded view: consumers must finish
        with a chunk before advancing the iterator.
        """
        if buf is None:
            buf = np.empty((chunk_rows, self.n_cols), self.dtype)
        if buf.shape[1] != self.n_cols or buf.dtype != self.dtype or len(buf) < chunk_rows:
            raise ValueError("buffer mismatch")
        with self._zf.open(self.member) as f:
            version = np.lib.format.read_magic(f)
            (np.lib.format.read_array_header_1_0 if version == (1, 0)
             else np.lib.format.read_array_header_2_0)(f)
            for row0 in range(0, self.n_rows, chunk_rows):
                rows = min(chunk_rows, self.n_rows - row0)
                view = buf[:rows]
                self._readinto(f, memoryview(view).cast("B"))
                yield row0, view


def default_chunk_rows(n_cols: int, itemsize: int = 4, target_bytes: int = 64 << 20) -> int:
    return max(1, target_bytes // max(1, n_cols * itemsize))


def streamed_scaler_fit(reader: NpzMemberReader, keep: np.ndarray,
                        chunk_rows: int | None = None):
    """Streamed train-fit scaler, ``standardize_fmri_betas`` semantics.

    Accumulates row-sequentially in float64: the same per-element operation
    order as ``train.mean(axis=0, dtype=np.float64)`` /
    ``np.var(train, axis=0, dtype=np.float64)`` on a C-order array (numpy
    reduces a strided axis 0 sequentially; pairwise summation applies only
    to the contiguous inner axis), so the float32-rounded statistics are
    bitwise those of the eager path.  Two passes over the file; O(chunk)
    host memory.
    """
    keep = np.asarray(keep, bool)
    n_keep = int(keep.sum())
    n = reader.n_rows
    chunk_rows = chunk_rows or default_chunk_rows(reader.n_cols, reader.dtype.itemsize)
    raw = np.empty((chunk_rows, reader.n_cols), reader.dtype)
    kept = np.empty((chunk_rows, n_keep), np.float32)

    acc = np.zeros(n_keep, np.float64)
    for _, view in reader.iter_row_chunks(chunk_rows, raw):
        k = np.compress(keep, view, axis=1, out=kept[: len(view)])
        for row in k:
            acc += row  # f32 row cast-added into the f64 accumulator
    mean64 = acc / n

    acc2 = np.zeros(n_keep, np.float64)
    dev = np.empty(n_keep, np.float64)
    for _, view in reader.iter_row_chunks(chunk_rows, raw):
        k = np.compress(keep, view, axis=1, out=kept[: len(view)])
        for row in k:
            np.subtract(row, mean64, out=dev)
            np.multiply(dev, dev, out=dev)
            acc2 += dev
    std64 = np.sqrt(acc2 / n)
    scale64 = np.where(std64 == 0.0, 1.0, std64)
    return mean64.astype(np.float32), scale64.astype(np.float32)


def streamed_x_all_device(readers, keep: np.ndarray, mean32: np.ndarray, scale32: np.ndarray,
                          mesh=None, device=None, chunk_rows: int | None = None,
                          dtype=torch.float32) -> torch.Tensor:
    """Stream the standardised rows of every split into one
    [sum(n_rows), V_kept] tensor of ``dtype`` on the device (the runner's
    ``X_all``).

    ``readers``: NpzMemberReader of (train, test, imagery) in the eager
    concatenation order.  The device is ``mesh.device`` with a mesh (each
    rank streams its own replica), else ``resolve_device(device)``.  The
    rows are standardised in float32 and then cast (``torch.bfloat16``: fast
    math's storage, rounded to nearest even on the device), so the result
    equals the eager float32 path cast to ``dtype``, element for element.
    """
    device = mesh.device if mesh is not None else resolve_device(device)
    keep = np.asarray(keep, bool)
    n_keep = int(keep.sum())
    n_cols = readers[0].n_cols
    if any(r.n_cols != n_cols for r in readers):
        raise ValueError("split column counts differ")
    if any(r.dtype != np.float32 for r in readers):
        raise ValueError("streaming ingestion needs float32 betas caches")
    chunk_rows = chunk_rows or default_chunk_rows(n_cols)
    X = torch.empty((sum(r.n_rows for r in readers), n_keep), dtype=dtype, device=device)

    on_cuda = device.type == "cuda"
    # two host buffers, pinned on CUDA; on the CPU the copy is synchronous
    # and one buffer is reused
    bufs = [torch.empty((chunk_rows, n_keep), dtype=torch.float32, pin_memory=on_cuda)
            for _ in range(2 if on_cuda else 1)]
    copied = [None] * len(bufs)  # CUDA event after each buffer's last copy
    raw = np.empty((chunk_rows, n_cols), np.float32)
    offset, i = 0, 0
    for reader in readers:
        for row0, view in reader.iter_row_chunks(chunk_rows, raw):
            slot = i % len(bufs)
            if copied[slot] is not None:
                copied[slot].synchronize()  # the card has read this buffer
            rows = len(view)
            host = bufs[slot][:rows]
            k = np.compress(keep, view, axis=1, out=host.numpy())
            k -= mean32
            k /= scale32
            rows_x = X[offset + row0:offset + row0 + rows]
            if dtype == torch.float32:
                rows_x.copy_(host, non_blocking=on_cuda)
            else:  # the float32 chunk crosses as it is and is cast on the device
                rows_x.copy_(host.to(device, non_blocking=on_cuda))
            if on_cuda:
                copied[slot] = torch.cuda.Event()
                copied[slot].record(torch.cuda.current_stream(device))
            i += 1
        offset += reader.n_rows
    if on_cuda:
        torch.cuda.current_stream(device).synchronize()
    return X
