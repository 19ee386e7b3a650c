"""The port's observability module against the JAX package's `obs.py`:
`Metrics` and `waterfall` (host numpy, copied) give equal counters, gauges
and spectrograms; `rx_diagnostics` on the port's chain meets
tests/test_obs_gbf.py:55-74's bars, and its constellation and channel
magnitude agree with the JAX chain's on the same buffer within 1e-3 of
their scale (the JAX chain mixes the found offset in float32 phase, ~1e-3
rad at these buffer lengths)."""

import numpy as np
import pytest
import torch

from mercury_tpu import obs as jobs
from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu_torch import obs
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the LDPC's small CPU tensors run far slower with
    MKL's threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_metrics_and_waterfall_match_jax():
    ours, theirs = obs.Metrics(), jobs.Metrics()
    for m in (ours, theirs):
        m.count("frames")
        m.count("frames", 2)
        m.gauge("snr", 12.5)
        with m.timer("decode"):
            pass
    assert ours.counters == theirs.counters and ours.gauges == theirs.gauges
    assert list(ours.timings) == list(theirs.timings) == ["decode"]
    rep = ours.report()
    assert "frames: 3" in rep and "snr: 12.5" in rep and "decode" in rep
    assert rep.split("== timings")[0] == theirs.report().split("== timings")[0]
    assert isinstance(obs.METRICS, obs.Metrics)
    x = np.random.default_rng(0).standard_normal(5000)
    for a, b in zip(obs.waterfall(x), jobs.waterfall(x)):
        np.testing.assert_array_equal(a, b)


def test_rx_diagnostics_matches_jax():
    """CONFIG_9 at 14 dB, a frame at sample 7000 shifted by 12 Hz: the bars
    of tests/test_obs_gbf.py:55-74, then the same fields as the JAX
    diagnostics."""
    g = build_geometry(9)
    payload = np.arange(g.frame_bytes, dtype=np.uint8)[None]
    frame = sim.apply_cfo(TxChain(port_geometry(9), device="cpu").transmit(
        torch.as_tensor(payload)), g.fs, g.fc, 12.0).numpy()[0]
    n = g.nofdm * g.buffer_nsymb * g.interp
    rng = np.random.default_rng(1)
    buf = rng.standard_normal(n) * sim.sigma_for_esn0(14.0)
    buf[7000: 7000 + len(frame)] += frame
    buf = buf.astype(np.float32)
    d = obs.rx_diagnostics(RxChain(port_geometry(9), device="cpu"), buf)
    assert d["crc_ok"]
    assert d["constellation"].shape == (g.n_data,)
    assert d["channel_mag"].shape == (g.nsymb, g.nc)
    assert d["sync_metric"].max() > 0.7
    assert d["waterfall"].shape[1] == 257
    assert all(isinstance(v, np.ndarray) for k, v in d.items()
               if k in ("sync_metric", "constellation", "channel_mag",
                        "waterfall", "waterfall_freqs"))
    want = jobs.rx_diagnostics(JaxRx(g), buf)
    assert d["delay"] == want["delay"] and d["crc_ok"] == want["crc_ok"]
    assert abs(d["freq_offset"] - want["freq_offset"]) < 0.05
    assert abs(d["snr_db"] - want["snr_db"]) < 0.05
    np.testing.assert_allclose(d["sync_metric"], want["sync_metric"],
                               atol=1e-4)
    for key in ("constellation", "channel_mag"):
        np.testing.assert_allclose(d[key], want[key],
                                   atol=1e-3 * np.abs(want[key]).max())
    assert abs(d["pilot_variance"] - want["pilot_variance"]) < 1e-3
    np.testing.assert_array_equal(d["waterfall"], want["waterfall"])
