"""multimodal_decoding_tpu_torch — the PyTorch/CUDA port of multimodal_decoding_tpu.

The port runs the package's main path, the per-vertex alpha-CV ridge
searchlight with per-shuffle null scoring, on one NVIDIA H100.  Subpackages
and modules mirror ``multimodal_decoding_tpu`` name for name, so each
counterpart sits at the same relative path.

Rules the package keeps:

* It imports ``torch``, numpy and scipy, never ``jax`` and nothing of
  ``multimodal_decoding_tpu``.  The JAX package's framework-free modules
  (``config``, ``data/*``, ``io/{gifti,nifti,artifacts}``, the mesh readers
  of ``io/surface``, ``utils/runlog``) are kept here as copies, so the result
  pickles, ``null_distr.npz`` files and path contracts stay interchangeable.
* Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
  (``device.resolve_device``); with no GPU they raise instead of running on
  the CPU.
* Strict float32 throughout: TF32 is switched off in ``device``.
* The one TPU kernel on this path, ``ops/pallas_solvers.py::chol_inv_panel``,
  is a hand-written CUDA kernel here (``csrc/chol_inv_panel.cu``, wrapped by
  ``ops/hopper_solvers.py``).
"""

__version__ = "0.1.0"
