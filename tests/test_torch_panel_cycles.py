"""The panel kernel's cycle instrument (utils/panel_cycles.py) on its real source.

Only the source transformation runs here; building and timing need the card.
"""

import os

from multimodal_decoding_tpu_torch.ops import _cuda_build
from multimodal_decoding_tpu_torch.utils import panel_cycles


def test_instrument_stamps_every_block_barrier_of_the_kernel():
    with open(os.path.join(_cuda_build.CSRC_DIR, "chol_inv_panel.cu")) as f:
        source = f.read()
    out = panel_cycles.instrument(source)
    kernel = source[source.index("__global__"):source.index("}  // namespace")]
    stamps = out.count("prof[n_stamps++] = clock64();")
    # one at the start, one after each __syncthreads, one at the end
    assert stamps == kernel.count("__syncthreads();") + 2
    assert "int n, int ld, long long* prof) {" in out
    assert "int pb, void* stream, void* prof) {" in out
    assert "pb, ld, static_cast<long long*>(prof));" in out
    # the device functions before the kernel are untouched
    assert out[:source.index("__global__")] == source[:source.index("__global__")]
