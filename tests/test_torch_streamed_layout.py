"""Layouts the streamed-count kernels are handed, checked on the CPU.

The kernels copy an operand 16 bytes at a time where its rows start 16 bytes
apart, so the port allocates Z and U through ``HM.padded_empty``.  These
tests hold that such a view is filled with exactly the values of the plain
product, so the padding changes no score, and that the fused scorers keep
their results with it.  ``_cuda_build.ptxas_report`` reads ``ptxas -v``'s
log into the line chip_smoke.py prints.
"""

import numpy as np
import pytest
import torch

from multimodal_decoding_tpu_torch.decoding import searchlight_engine as E
from multimodal_decoding_tpu_torch.ops import _cuda_build
from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM


@pytest.mark.parametrize("cols", [1, 4, 7, 130, 1639])
def test_padded_empty_rows_start_16_bytes_apart(cols):
    x = HM.padded_empty(3, 5, cols, "cpu")
    assert x.shape == (3, 5, cols) and x.dtype == torch.float32
    assert x.stride(2) == 1 and x.stride(1) % 4 == 0 and x.stride(1) - cols < 4
    assert x.stride(0) == 5 * x.stride(1)


@pytest.mark.parametrize("cols", [37, 40])
def test_matmul_into_padded_view_equals_the_plain_product(cols):
    rng = np.random.default_rng(cols)
    inv = torch.as_tensor(rng.standard_normal((4, 30, 30), dtype=np.float32))
    U = torch.as_tensor(rng.standard_normal((4, 30, cols), dtype=np.float32))
    Z = torch.matmul(inv, U, out=HM.padded_empty(4, 30, cols, "cpu"))
    assert Z.stride(1) % 4 == 0
    assert torch.equal(Z, inv @ U)


@pytest.mark.parametrize("scorer", ["fused-pallas", "fused-inv"])
def test_streamed_fused_scorers_agree_with_dense_fused(scorer):
    """U and Z in padded rows (fused-pallas, fused-inv) give the CV scores of
    the dense "fused" scorer, which forms them unpadded."""
    rng = np.random.default_rng(7)
    n, b, k, d = 60, 3, 6, 5
    Xg = torch.as_tensor(rng.standard_normal((n, b, k), dtype=np.float32))
    Y = torch.as_tensor(rng.standard_normal((n, d), dtype=np.float32))
    alphas = torch.tensor([1e-1, 1e1, 1e3])
    ref = E.fit_block_cv(Xg, Y, alphas, cv_scorer="fused")
    got = E.fit_block_cv(Xg, Y, alphas, cv_scorer=scorer)
    assert torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=1e-6)


def test_ptxas_report_reads_registers_spills_and_shared_memory(monkeypatch):
    log = ("ptxas info    : 0 bytes gmem\n"
           "ptxas info    : Compiling entry function '_Z1fv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1fv\n"
           "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes smem, "
           "384 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1gv\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 40 registers, 384 bytes cmem[0]\n")
    monkeypatch.setattr(_cuda_build, "_ptxas_logs", {"x.cu": log})
    monkeypatch.setattr(_cuda_build, "_demangle", lambda names: names)
    assert _cuda_build.ptxas_report() == [
        {"source": "x.cu", "kernel": "_Z1fv", "registers": 168, "spill_store_bytes": 8,
         "spill_load_bytes": 12, "static_smem_bytes": 1024},
        {"source": "x.cu", "kernel": "_Z1gv", "registers": 40, "spill_store_bytes": 0,
         "spill_load_bytes": 0, "static_smem_bytes": 0},
    ]
