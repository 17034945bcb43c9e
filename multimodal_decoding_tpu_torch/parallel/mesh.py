"""Process meshes over ``torch.distributed``: one process per device.

Port of ``multimodal_decoding_tpu/parallel/mesh.py``.  The JAX package has
one process drive a ``jax.sharding.Mesh`` with ``shard_map``; here each GPU
is driven by its own process, started by ``torchrun``, and the processes
form one ``torch.distributed`` world:

* NCCL joins CUDA ranks, gloo joins CPU ranks (gloo only when the caller
  asked for the CPU: on CUDA tensors gloo has no all_gather);
* a ``Mesh`` is a thin view of that world that keeps the JAX axis names:
  ``"v"`` (vertices and permutations: the searchlight blocks, the group null)
  and ``"f"`` (features: the whole-brain gram);
* ``init_world`` is the one place that initialises the default process
  group.  Started by ``torchrun`` it reads ``RANK``, ``WORLD_SIZE`` and
  ``MASTER_ADDR``/``MASTER_PORT`` (and sets the CUDA device to
  ``LOCAL_RANK`` first); otherwise it makes a world of one, as a
  one-device ``Mesh`` is in JAX.

The JAX package's single-process emulation of hosts at device granularity
has no counterpart: the port's tests run real processes (``spawn_world``).
NCCL puts at most one rank on a GPU, so one card shows only a world of one.
"""

from __future__ import annotations

import datetime
import os
import socket
import traceback
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from multimodal_decoding_tpu_torch.device import resolve_device

VERTEX_AXIS = "v"
FEATURE_AXIS = "f"

#: Seconds a collective may wait for a lost rank before the run fails.
COLLECTIVE_TIMEOUT_S = 600


@dataclass(frozen=True)
class Mesh:
    """One axis over the ranks of the default process group.

    ``device`` is where this rank's tensors live: ``cuda:<LOCAL_RANK>`` on
    NCCL, ``cpu`` on gloo.
    """

    axis: str
    device: torch.device

    @property
    def size(self) -> int:
        return dist.get_world_size()

    @property
    def rank(self) -> int:
        return dist.get_rank()


def launched_world_size() -> int:
    """The world size ``torchrun`` set in the environment (1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_world(device=None) -> torch.device:
    """Initialise the default process group once; returns this rank's device.

    ``device`` as in ``device.resolve_device`` (``None``: cuda, which raises
    without a GPU).  A group that already exists is reused if its backend
    fits the device, and refused if not: the port never runs CUDA ranks on
    gloo.  A failed NCCL initialisation raises.
    """
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, but a "
                               f"{device.type} mesh needs {backend}")
        return device
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    extra = {"device_id": device} if device.type == "cuda" else {}
    if launched_world_size() > 1 or "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout,
                                rank=int(os.environ["RANK"]),
                                world_size=launched_world_size(), **extra)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout, **extra)
    return device


def vertex_mesh(device=None) -> Mesh:
    """The world as a ``"v"`` axis (searchlight blocks, group permutations)."""
    return Mesh(VERTEX_AXIS, init_world(device))


def feature_mesh(device=None) -> Mesh:
    """The world as an ``"f"`` axis (the whole-brain gram's columns)."""
    return Mesh(FEATURE_AXIS, init_world(device))


def resolve_mesh(mesh, axis: str, device=None):
    """``mesh`` as given, with ``"auto"`` meaning the world over ``axis``."""
    if mesh == "auto":
        return Mesh(axis, init_world(device))
    return mesh


def is_writer(mesh) -> bool:
    """Whether this rank writes shared artifacts: rank 0, or any run without a mesh."""
    return mesh is None or mesh.rank == 0


def barrier(mesh) -> None:
    """Wait for every rank of ``mesh`` (nothing without one)."""
    if mesh is not None:
        dist.barrier()


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0, fill=None):
    """Pad ``axis`` up to a multiple; returns (padded, original_length).

    fill=None repeats the first slice (safe for index arrays: padded vertices
    recompute vertex 0 and are dropped on the host).
    """
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr, n
    pad_n = target - n
    if fill is None:
        filler = np.repeat(np.take(arr, [0], axis=axis), pad_n, axis=axis)
    else:
        shape = list(arr.shape)
        shape[axis] = pad_n
        filler = np.full(shape, fill, dtype=arr.dtype)
    return np.concatenate([arr, filler], axis=axis), n


# ---------------------------------------------------------------------------
# Starting a world from one process (the dry run and the CPU tests)
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, device, fn, args, queue):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank))
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        init_world(device)
        queue.put((rank, True, fn(*args)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(fn, world_size: int, args=(), device: str = "cpu",
                timeout_s: float = 300.0) -> list:
    """Run ``fn(*args)`` in ``world_size`` new processes joined as one world.

    Each process is a rank (gloo on ``"cpu"``, NCCL on ``"cuda"`` with rank r
    on GPU r), initialised as ``torchrun`` would, and calls ``fn`` after
    ``init_world``.  ``fn`` must be importable (a module-level function).
    Returns every rank's return value, by rank; raises with the first
    failing rank's traceback, or when the world takes over ``timeout_s``
    (its processes are then killed).
    """
    import multiprocessing
    import queue as queue_mod

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world_size, port, device, fn, args, q))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, deadline = {}, datetime.datetime.now() + datetime.timedelta(seconds=timeout_s)
    try:
        while len(results) < world_size:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, ok, value = q.get(timeout=max(left, 0.01))
            except queue_mod.Empty:
                raise TimeoutError(f"world of {world_size} did not finish in {timeout_s} s; "
                                   f"ranks done: {sorted(results)}") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=max((deadline - datetime.datetime.now()).total_seconds(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world_size)]
