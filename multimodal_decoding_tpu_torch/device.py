"""Device selection and the package's float32 precision settings.

Precision: every float32 matrix product of the port runs in full float32.
PyTorch keeps cuBLAS out of TF32 by default but lets cuDNN use it; both
switches are set off here, at import, so no path of the port depends on a
caller's global settings.  TF32 keeps ~3 decimal digits, far too few for the
CV alpha selection and the 1e-4 final-score parity with the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means ``cuda``.  A CUDA device without a visible GPU raises:
    the port never falls back to the CPU on its own; a caller who wants the
    CPU asks for ``"cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run the port on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def as_float32(x, device=None) -> torch.Tensor:
    """``x`` as a float32 tensor.

    A tensor stays on its device unless ``device`` names one; anything else
    (numpy arrays, JAX outputs) goes to ``resolve_device(device)``.  A
    read-only array is copied, since tensors are writable.
    """
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32) if device is None else x.to(resolve_device(device),
                                                              torch.float32)
    x = np.asarray(x, dtype=np.float32)
    if not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, device=resolve_device(device))
