"""mercury_tpu_torch.dsp.ops against mercury_tpu.dsp.ops on the same numpy
inputs. Tolerances: atol 1e-5 / rtol 1e-4 in float32 and complex64
(different summation orders), 1e-10 in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.dsp import ops as jops
from mercury_tpu_torch.dsp import ops

TOL = {np.float32: dict(atol=1e-5, rtol=1e-4),
       np.float64: dict(atol=1e-10, rtol=1e-10)}
CPLX = {np.float32: np.complex64, np.float64: np.complex128}


@pytest.fixture(scope="module")
def geom():
    return build_geometry(3, with_pre_eq=False)


def _signal(rng, shape, dtype, complex_=True):
    x = rng.standard_normal(shape)
    if complex_:
        x = x + 1j * rng.standard_normal(shape)
        return x.astype(CPLX[dtype])
    return x.astype(dtype)


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("complex_", [False, True])
def test_fir_same(geom, dtype, complex_):
    rng = np.random.default_rng(0)
    x = _signal(rng, (3, 1001), dtype, complex_)
    taps = geom.fir_rx_ts.astype(dtype)
    _close(ops.fir_same(torch.as_tensor(x), torch.as_tensor(taps)),
           jops.fir_same(jnp.asarray(x), jnp.asarray(taps)), dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("stride", [2, 4])
def test_fir_same_strided(geom, dtype, stride):
    rng = np.random.default_rng(1)
    x = _signal(rng, (2, 1023), dtype)
    taps = geom.fir_rx_ts.astype(dtype)
    got = ops.fir_same_strided(torch.as_tensor(x), torch.as_tensor(taps), stride)
    want = jops.fir_same_strided(jnp.asarray(x), jnp.asarray(taps), stride)
    assert got.shape == want.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fir_decimate_segment(geom, dtype):
    rng = np.random.default_rng(2)
    seg = _signal(rng, (3, 4 * 200 + 32), dtype)
    taps = geom.fir_rx_data.astype(dtype)
    got = ops.fir_decimate_segment(torch.as_tensor(seg), torch.as_tensor(taps), 4)
    want = jops.fir_decimate_segment(jnp.asarray(seg), jnp.asarray(taps), 4)
    assert got.shape == want.shape == (3, 200)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_linear_interp_mix_clip(geom, dtype):
    rng = np.random.default_rng(3)
    x = _signal(rng, (2, 300), dtype)
    up = ops.linear_interp(torch.as_tensor(x), 4)
    up_j = jops.linear_interp(jnp.asarray(x), 4)
    _close(up, up_j, dtype)
    pb = ops.mix_to_passband(up, geom.fs, geom.fc, float(np.sqrt(2.0)), 7)
    pb_j = jops.mix_to_passband(up_j, geom.fs, geom.fc, float(np.sqrt(2.0)), 7)
    _close(pb, pb_j, dtype)
    _close(ops.peak_clip(pb, 3.0), jops.peak_clip(pb_j, 3.0), dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ofdm_mod_demod(geom, dtype):
    rng = np.random.default_rng(4)
    g = geom
    carriers = _signal(rng, (2, 5, g.nc), dtype)
    pad_map = np.asarray(g.pad_map)
    td = ops.ofdm_mod(torch.as_tensor(carriers), torch.as_tensor(pad_map),
                      g.nfft, g.ngi)
    td_j = jops.ofdm_mod(jnp.asarray(carriers), pad_map, g.nfft, g.ngi)
    assert td.shape == td_j.shape == (2, 5, g.nfft + g.ngi)
    _close(td, td_j, dtype)
    back = ops.ofdm_demod(td, torch.as_tensor(pad_map), g.nfft, g.ngi)
    back_j = jops.ofdm_demod(td_j, pad_map, g.nfft, g.ngi, use_mm=False)
    _close(back, back_j, dtype)
    # the 1/N forward FFT undoes the unnormalized inverse
    _close(back, carriers, dtype)
