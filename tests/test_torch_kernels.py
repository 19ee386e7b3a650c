"""The plain versions of the CUDA kernels for the front-end FIR and the
matched-filter scores against the Pallas kernels they replace (interpret
mode on the CPU; deep_mf_max and pilot_cand_score are held to theirs in
tests/test_torch_coherent.py and tests/test_torch_pilot.py). The kernels themselves are held against
their plain versions on the card in tests/test_torch_cuda.py.

Tolerances: the front-end FIR atol 1e-5 / rtol 1e-4 (float32 sums in a
different order); the matched-filter scores rtol/atol 1e-3 with equal argmax
lags (FFT versus direct correlation, as tests/test_pallas.py holds the
Pallas kernel to the XLA path)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.dsp import pallas_kernels
from mercury_tpu_torch.dsp import kernels


@pytest.fixture(scope="module")
def geom():
    return build_geometry(0, with_pre_eq=False)


def _osc(g, n):
    ph = (2 * np.pi * g.fc / g.fs) * np.arange(n, dtype=np.float64)
    return (np.sqrt(2) * (np.cos(ph) + 1j * np.sin(ph))).astype(np.complex64)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_mix_fir_decimate_ref_matches_pallas(geom, stride):
    rng = np.random.default_rng(0)
    pb = rng.standard_normal((3, 8192)).astype(np.float32)
    taps = geom.fir_rx_ts.astype(np.float32)
    want = pallas_kernels.mix_fir_decimate(jnp.asarray(pb), jnp.asarray(taps),
                                           geom.fs, geom.fc, stride=stride,
                                           interpret=True)
    got = kernels.mix_fir_decimate(torch.as_tensor(pb),
                                   torch.as_tensor(_osc(geom, 8192)),
                                   torch.as_tensor(taps), stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("cfg", [3, 9])
def test_mix_fir_decimate_row_starts_match_frame_extraction(cfg):
    """Per-row-start form == the JAX RxChain's data-FIR frame extraction,
    including starts clipped at both buffer edges."""
    from mercury_tpu.modem.rx import RxChain as JaxRx
    from mercury_tpu_torch.modem.rx import RxChain

    g = build_geometry(cfg)
    rng = np.random.default_rng(cfg)
    n = g.nofdm * g.buffer_nsymb * g.interp
    pb = rng.standard_normal((4, n)).astype(np.float32)
    frame = g.nofdm * (g.nsymb + g.preamble_nsymb) * g.interp
    delay = np.array([0, 1234, n - frame, n], dtype=np.int64)
    want = JaxRx(g).extract_frame_decimated_pb(
        jnp.asarray(pb), jnp.asarray(delay, jnp.int32), g.nsymb)
    got = RxChain(g).extract_frame_decimated_pb(
        torch.as_tensor(pb), torch.as_tensor(delay), g.nsymb)
    assert got.shape == want.shape == (4, frame // g.interp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-4)


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


@pytest.mark.parametrize("case", [
    # tests/test_pallas.py:212 (planted peak + silence row)
    dict(seed=15, a=3, lp=4, s=96, window=280, rows=5, plant=(2, 1, 150),
         silence=4, nfft=1024),
    # tests/test_pallas.py:245 (undersized transform grown inside)
    dict(seed=23, a=2, lp=4, s=40, window=200, rows=3, plant=(1, 0, 77),
         nfft=256),
])
def test_deep_mf_score_ref_matches_pallas(case):
    case = dict(case)
    nfft = case.pop("nfft")
    seg, bank = _deep_case(**case)
    window = case["window"]
    want = np.asarray(pallas_kernels.deep_mf_score(
        jnp.asarray(seg), bank, window, nfft, interpret=True))
    got = kernels.deep_mf_score(torch.as_tensor(seg), torch.as_tensor(bank),
                                window, nfft).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    row, hyp, lag = case["plant"]
    assert got[row, hyp].argmax() == lag


def test_cpu_tensors_take_the_plain_versions(geom):
    """On the CPU the wrappers return their plain versions and count no
    kernel launch; on any other non-CUDA device they raise."""
    kernels.reset_launch_counts()
    seg, bank = _deep_case(1, 2, 2, 16, 20, 2, (0, 1, 5))
    s = kernels.deep_mf_score(torch.as_tensor(seg), torch.as_tensor(bank), 20)
    torch.testing.assert_close(s, kernels.deep_mf_score_ref(
        torch.as_tensor(seg), torch.as_tensor(bank), 20), rtol=0, atol=0)
    pb = torch.randn(2, 512)
    osc = torch.as_tensor(_osc(geom, 512))
    taps = torch.as_tensor(geom.fir_rx_ts.astype(np.float32))
    kernels.mix_fir_decimate(pb, osc, taps, 4)
    smax, sarg = kernels.deep_mf_max(torch.as_tensor(seg),
                                     torch.as_tensor(bank), 20)
    torch.testing.assert_close(smax, s.amax(1), rtol=0, atol=0)
    torch.testing.assert_close(sarg, s.argmax(1), rtol=0, atol=0)
    bb = torch.as_tensor(seg)
    idx0 = torch.tensor([[0, 3], [9, 1]])
    pil = torch.as_tensor(bank)
    torch.testing.assert_close(
        kernels.pilot_cand_score(bb, idx0, idx0 % 2, pil),
        kernels.pilot_cand_score_ref(bb, idx0, idx0 % 2, pil), rtol=0, atol=0)
    assert set(kernels.LAUNCHES) == {"mix_fir_decimate", "deep_mf_score",
                                     "deep_mf_max", "pilot_cand_score"}
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.mix_fir_decimate(pb.to("meta"), osc.to("meta"),
                                 taps.to("meta"), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.deep_mf_score(torch.as_tensor(seg).to("meta"),
                              torch.as_tensor(bank).to("meta"), 20)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.deep_mf_max(torch.as_tensor(seg).to("meta"),
                            torch.as_tensor(bank).to("meta"), 20)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.pilot_cand_score(bb.to("meta"), idx0.to("meta"),
                                 idx0.to("meta"), pil.to("meta"))
