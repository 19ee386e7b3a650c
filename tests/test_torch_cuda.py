"""The CUDA kernels against their plain versions, on the card (marker
`cuda`; skipped without a GPU, since a CUDA kernel has no CPU mode).

This file imports no JAX, so it runs on a machine with the card and no JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
Tolerances as in tests/test_torch_kernels.py: FIR atol 1e-5 / rtol 1e-4,
matched-filter scores rtol/atol 1e-3 with equal argmax lags."""

import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu_torch.dsp import kernels


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def geom():
    return build_geometry(0, with_pre_eq=False)


def _osc(g, n):
    ph = (2 * np.pi * g.fc / g.fs) * np.arange(n, dtype=np.float64)
    return (np.sqrt(2) * (np.cos(ph) + 1j * np.sin(ph))).astype(np.complex64)


def _deep_case(seed, a, lp, s, window, rows, plant, silence=None):
    rng = np.random.default_rng(seed)
    bank = (rng.standard_normal((a, lp, s))
            + 1j * rng.standard_normal((a, lp, s))).astype(np.complex64)
    seg_len = 2 * window + lp * s
    seg = (rng.standard_normal((rows, seg_len))
           + 1j * rng.standard_normal((rows, seg_len))).astype(np.complex64)
    row, hyp, lag = plant
    seg[row, lag: lag + lp * s] += 5.0 * bank[hyp].reshape(-1)
    if silence is not None:
        seg[silence, :40] = 0.0
    return seg, bank


@pytest.mark.cuda
def test_mix_fir_decimate_kernel_matches_plain(cuda_device, geom):
    rng = np.random.default_rng(5)
    n = 8192
    pb = torch.as_tensor(rng.standard_normal((5, n)).astype(np.float32),
                         device=cuda_device)
    osc = torch.as_tensor(_osc(geom, n), device=cuda_device)
    taps = torch.as_tensor(geom.fir_rx_data.astype(np.float32),
                           device=cuda_device)
    before = kernels.LAUNCHES["mix_fir_decimate"]
    for stride in (1, 2, 4):
        got = kernels.mix_fir_decimate(pb, osc, taps, stride)
        want = kernels.mix_fir_decimate_ref(pb, osc, taps, stride)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    start = torch.tensor([0, 17, 4000, 6000, 8300], device=cuda_device)
    got = kernels.mix_fir_decimate(pb, osc, taps, 4, start=start, n_out=700,
                                   offset=16)
    want = kernels.mix_fir_decimate_ref(pb, osc, taps, 4, start=start,
                                        n_out=700, offset=16)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    assert kernels.LAUNCHES["mix_fir_decimate"] == before + 4


@pytest.mark.cuda
def test_deep_mf_score_kernel_matches_plain(cuda_device):
    seg, bank = _deep_case(15, 3, 4, 96, 280, 5, (2, 1, 150), silence=4)
    seg_t = torch.as_tensor(seg, device=cuda_device)
    bank_t = torch.as_tensor(bank, device=cuda_device)
    got = kernels.deep_mf_score(seg_t, bank_t, 280)
    want = kernels.deep_mf_score_ref(seg_t, bank_t, 280)
    torch.testing.assert_close(got.argmax(-1), want.argmax(-1))
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert int(got[2, 1].argmax()) == 150
