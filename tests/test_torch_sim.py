"""mercury_tpu_torch.channel.sim: the frame lands at its delay and the
noise has the calibrated statistics (its samples come from a
torch.Generator, so only statistics are comparable with the JAX package);
sigma_for_channel_snr, apply_cfo and multipath against the JAX functions
(float32: atol 1e-5), watterson equal to the JAX package's for the same
input and seed (exact: both are the same host numpy), the fading process's
statistics, and one CONFIG_0 receive under Watterson fading against the
JAX chain's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.channel import sim as jsim
from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """MKL threads tanh on the LDPC's small tensors at a cost far above the
    work; one thread keeps the CPU decodes short."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_sigma_matches_reference_convention():
    for esn0 in (-5.0, 0.0, 12.0):
        assert sim.sigma_for_esn0(esn0) == pytest.approx(
            jsim.sigma_for_esn0(esn0), rel=1e-15)


def test_awgn_passband_placement_and_statistics():
    frame = torch.randn(4, 3000, generator=torch.Generator().manual_seed(1))
    sigma = sim.sigma_for_esn0(6.0)
    buf = sim.awgn_passband(frame, sigma, 1000, 200_000,
                            torch.Generator().manual_seed(2))
    assert buf.shape == (4, 200_000) and buf.dtype == torch.float32
    quiet = sim.awgn_passband(frame, 0.0, 1000, 200_000,
                              torch.Generator().manual_seed(2))
    torch.testing.assert_close(quiet[:, 1000:4000], frame, rtol=0, atol=0)
    assert (quiet[:, :1000] == 0).all() and (quiet[:, 4000:] == 0).all()
    noise = torch.cat([buf[:, :1000], buf[:, 4000:]], dim=-1).double()
    # 4 x 197000 samples: the std of the estimate is ~0.08% of sigma
    assert abs(noise.std().item() / sigma - 1.0) < 0.005
    assert abs(noise.mean().item()) < 0.005 * sigma
    torch.testing.assert_close(buf[:, 1000:4000] - frame,
                               buf[:, 1000:4000] - quiet[:, 1000:4000])
    # the same generator seed gives the same buffer
    again = sim.awgn_passband(frame, sigma, 1000, 200_000,
                              torch.Generator().manual_seed(2))
    torch.testing.assert_close(again, buf, rtol=0, atol=0)



def test_sigma_for_channel_snr_matches_jax():
    """A numpy frame and a tensor give the JAX function's sigma (the port
    takes the frame's power in float64, JAX in the frame's float32)."""
    frame = np.random.default_rng(3).standard_normal(50_000).astype(np.float32)
    for snr in (-13.0, -5.0, 12.0):
        want = jsim.sigma_for_channel_snr(frame, snr, 48000.0, 2343.75)
        for x in (frame, torch.as_tensor(frame)):
            assert sim.sigma_for_channel_snr(x, snr, 48000.0, 2343.75) == \
                pytest.approx(want, rel=1e-6)


def test_apply_cfo_and_multipath_match_jax():
    pb = np.random.default_rng(4).standard_normal((3, 4801)).astype(np.float32)
    for offset in (0.0, 37.5, -61.2):
        want = np.asarray(jsim.apply_cfo(jnp.asarray(pb), 48000.0, 1500.0,
                                         offset))
        got = sim.apply_cfo(torch.as_tensor(pb), 48000.0, 1500.0, offset)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    delays, gains = [0, 3, 48], [1.0, -0.5, 0.25]
    want = np.asarray(jsim.multipath(jnp.asarray(pb), delays, gains))
    got = sim.multipath(torch.as_tensor(pb), delays, gains)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("preset", ["good", "moderate", "poor"])
def test_watterson_equals_jax(preset):
    pb = np.random.default_rng(5).standard_normal((2, 20_000))
    assert sim.WATTERSON_PRESETS[preset] == jsim.WATTERSON_PRESETS[preset]
    kw = dict(sim.WATTERSON_PRESETS[preset], seed=11)
    want = jsim.watterson(pb, **kw)
    np.testing.assert_array_equal(sim.watterson(pb, **kw), want)
    np.testing.assert_array_equal(sim.watterson(torch.as_tensor(pb), **kw),
                                  want)
    np.testing.assert_array_equal(sim.watterson(pb[1], **kw),
                                  jsim.watterson(pb[1], **kw))


def test_fading_process_statistics():
    """tests/test_multipath.py:45: unit mean power, Rayleigh dips."""
    h = sim._fading_process(48000 * 4, 48000.0, 0.5,
                            np.random.default_rng(1))
    np.testing.assert_array_equal(
        h, jsim._fading_process(48000 * 4, 48000.0, 0.5,
                                np.random.default_rng(1)))
    assert abs(np.mean(np.abs(h) ** 2) - 1.0) < 0.35
    assert np.abs(h).min() < 0.5 < np.abs(h).max()


def test_config0_under_watterson_matches_jax():
    """tests/test_multipath.py:31's CONFIG_0 "moderate" point (Es/N0 10 dB)
    at batch 4: both receives decode the same rows at the same delays, and
    the decoded rows carry their payloads. The full-batch FER bars run on
    the card (chip_smoke.py)."""
    g = build_geometry(0)
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, (4, g.frame_bytes)).astype(np.uint8)
    frames = TxChain(port_geometry(0), device="cpu").transmit(
        torch.as_tensor(payload))
    faded = sim.watterson(frames, **sim.WATTERSON_PRESETS["moderate"],
                          seed=42)
    delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
    buf = rng.standard_normal((4, g.nofdm * g.buffer_nsymb * g.interp)) * \
        sim.sigma_for_esn0(10.0)
    buf[:, delay: delay + faded.shape[1]] += faded
    buf = buf.astype(np.float32)
    res = RxChain(port_geometry(0), device="cpu").receive(torch.as_tensor(buf))
    res_j = JaxRx(g).receive(jnp.asarray(buf))
    ok = res.crc_ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(res_j.crc_ok))
    np.testing.assert_array_equal(res.delay.numpy(), np.asarray(res_j.delay))
    assert ok.sum() >= 3 and (res.payload.numpy()[ok] == payload[ok]).all()
