"""State carried between the JAX package and the port.

The system learns no weights that outlive a run: what the two packages share
is a block step's inputs and the ridge weights ``W [B, K, D]`` that
``fit_block_cv`` returns in both, and the whole-brain decoder's state: the
gram and query kernels of its ``GramCache`` and the dual coefficients of
``ridge_cv_dual``.  ``block_inputs_from_numpy`` and
``whole_brain_state_from_numpy`` turn the JAX package's numpy arrays into the
port's tensors, with the same dtypes and layouts, on one device (``cuda``
unless the caller names one); ``gram_cache_from_numpy`` starts the port's
decoder from a JAX ``GramCache``; ``to_numpy`` brings outputs back.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_decoding_tpu_torch.decoding.whole_brain import GramCache
from multimodal_decoding_tpu_torch.device import as_float32, resolve_device

_DTYPES = {
    "X_all": torch.float32,       # [N_all, V] train, test, imagery rows
    "Y_train": torch.float32,     # [N, D]
    "Y_test": torch.float32,      # [n_test, D]
    "Y_imag": torch.float32,      # [n_imag, D]
    "idx": torch.int32,           # [B, K] neighbour indices
    "mask": torch.bool,           # [B, K] or None
    "alphas": torch.float32,      # [A]
    "shuffles": torch.int32,      # [P, n_test]
    "derangements": torch.int32,  # [B, P] imagery derangement choice
}


def block_inputs_from_numpy(device=None, **arrays) -> dict:
    """Numpy block-step inputs -> tensors on ``device``, keyed as given.

    Accepted keys: ``X_all, Y_train, Y_test, Y_imag, idx, mask, alphas,
    shuffles, derangements``; a ``None`` value stays ``None``.  ``device``
    defaults to ``cuda`` and raises without a GPU (``device.resolve_device``).
    """
    unknown = set(arrays) - set(_DTYPES)
    if unknown:
        raise ValueError(f"unknown block inputs: {sorted(unknown)}")
    device = resolve_device(device)
    return {
        name: None if a is None
        else torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=_DTYPES[name])
        for name, a in arrays.items()
    }


_WB_STATE = ("K", "K_test", "K_imag", "dual_coef")  # all float32


def whole_brain_state_from_numpy(device=None, **arrays) -> dict:
    """Numpy whole-brain state -> float32 tensors on ``device``, keyed as given.

    Accepted keys: ``K [N, N]``, ``K_test [n_test, N]``, ``K_imag [n_imag, N]``
    (a JAX ``GramCache``'s kernels) and ``dual_coef [N, D]`` (what JAX
    ``ridge_cv_dual`` returns).
    """
    unknown = set(arrays) - set(_WB_STATE)
    if unknown:
        raise ValueError(f"unknown whole-brain state: {sorted(unknown)}")
    device = resolve_device(device)
    return {name: as_float32(a, device) for name, a in arrays.items()}


def gram_cache_from_numpy(K, K_test, K_imag, device=None):
    """The port's ``GramCache`` around a JAX ``GramCache``'s kernels."""
    state = whole_brain_state_from_numpy(device, K=K, K_test=K_test, K_imag=K_imag)
    return GramCache.from_kernels(state["K"], state["K_test"], state["K_imag"])


def to_numpy(out):
    """Tensors (or dicts/tuples of them) -> numpy, for comparison with JAX outputs."""
    if isinstance(out, dict):
        return {k: to_numpy(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(to_numpy(v) for v in out)
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return out
