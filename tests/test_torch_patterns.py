"""mercury_tpu_torch.modem.patterns.PatternSignaler against the JAX
package's: the ACK and BREAK passbands (host numpy, within 1e-6), and
detect_ack / detect_break on the same buffers (metric within atol 1e-4,
rtol 1e-4: the JAX detector mixes in float32 phase, the port reads the
float64 oscillator table; matched counts equal). Then the first four tests
of tests/test_patterns.py on the port (ack_pattern_detection_test,
telecom_system.cc:1712-1802)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.modem.patterns import PatternSignaler as JaxSignaler
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.modem.patterns import PatternSignaler


@pytest.fixture(scope="module")
def sig():
    return PatternSignaler(port_geometry(0), device="cpu")


def _buffer(sig, pattern, snr_db, seed, b=4):
    """b copies of a pattern two symbols into a buffer, in white noise at
    snr_db channel SNR (tests/test_patterns.py:23)."""
    g = sig.geom
    delay = 2 * g.nofdm * g.interp
    buf_len = sig.passband_samples + 2 * delay
    p_sig = np.mean(pattern ** 2)
    sigma = np.sqrt(2.0 * p_sig * (g.fs / 2) /
                    (10 ** (snr_db / 10.0) * g.bandwidth)) / np.sqrt(2.0)
    buf = np.random.default_rng(seed).standard_normal((b, buf_len)) * sigma
    buf[:, delay: delay + pattern.size] += pattern
    return torch.as_tensor(buf, dtype=torch.float32)


@pytest.mark.parametrize("cfg", [0, 100])
def test_passbands_match_jax(cfg):
    want = JaxSignaler(build_geometry(cfg))
    got = PatternSignaler(port_geometry(cfg), device="cpu")
    assert (got.passband_samples, got.threshold) == (want.passband_samples,
                                                     want.threshold)
    np.testing.assert_allclose(got.ack_passband, want.ack_passband, atol=1e-6)
    np.testing.assert_allclose(got.break_passband, want.break_passband,
                               atol=1e-6)


@pytest.mark.parametrize("cfg", [0, 100])
def test_detection_matches_jax(cfg):
    """Each pattern at -13, -5 and 0 dB through both detectors."""
    want = JaxSignaler(build_geometry(cfg))
    got = PatternSignaler(port_geometry(cfg), device="cpu")
    for seed, snr in enumerate((-13.0, -5.0, 0.0)):
        for pattern in (got.ack_passband, got.break_passband):
            buf = _buffer(got, pattern, snr, seed)
            for det, det_j in ((got.detect_ack, want.detect_ack),
                               (got.detect_break, want.detect_break)):
                metric, matched = det(buf)
                metric_j, matched_j = det_j(jnp.asarray(buf.numpy()))
                np.testing.assert_allclose(metric.numpy(),
                                           np.asarray(metric_j), atol=1e-4,
                                           rtol=1e-4)
                np.testing.assert_array_equal(matched.numpy(),
                                              np.asarray(matched_j))


def test_ack_detected_at_operating_snr(sig):
    metric, matched = sig.detect_ack(_buffer(sig, sig.ack_passband, -5.0, 0))
    assert (metric >= sig.threshold).all()
    assert (matched >= 8).all()


def test_ack_metric_parity_weak_signal():
    """The reference's own ack_pattern_detection_test means: 0.978 at
    -13 dB, 4.671 at -5 dB (tests/test_patterns.py:41)."""
    s100 = PatternSignaler(port_geometry(100), device="cpu")
    for snr, ref_mean in [(-13.0, 0.978), (-5.0, 4.671)]:
        metric, _ = s100.detect_ack(_buffer(s100, s100.ack_passband, snr, 1,
                                            b=8))
        m = float(metric.mean())
        assert ref_mean * 0.6 <= m <= ref_mean * 1.4, (snr, m, ref_mean)


def test_no_false_alarm_on_noise(sig):
    g = sig.geom
    n = sig.passband_samples + 4 * g.nofdm * g.interp
    noise = 0.1 * torch.randn((8, n), generator=torch.Generator().manual_seed(2))
    metric, _ = sig.detect_ack(noise)
    assert (metric < sig.threshold).all(), metric


def test_break_not_detected_as_ack(sig):
    """The ACK and BREAK sequences collide at 2 of 16 hop positions, so the
    cross metric can reach the threshold at high SNR; the matched-count
    gate (>= half the symbols) rejects it (tests/test_patterns.py:61)."""
    buf = _buffer(sig, sig.break_passband, 0.0, 3)
    ack_metric, ack_matched = sig.detect_ack(buf)
    brk_metric, brk_matched = sig.detect_break(buf)
    assert (brk_metric >= sig.threshold).all()
    assert (brk_matched >= 8).all()
    assert (ack_matched < 8).all(), ack_matched
    assert (ack_metric < brk_metric * 0.5).all()
