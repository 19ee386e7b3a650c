"""Channel simulator: AWGN capture buffers, carrier offset, static multipath
and the Watterson HF fading channel (PyTorch port of the JAX package's
`channel/sim.py`). Noise samples come from a `torch.Generator`; only their
statistics match the JAX package, not the samples. The Watterson channel is
host numpy, as in the JAX package, and gives the same array for the same
input and seed."""

from __future__ import annotations

import math

import numpy as np
import torch


def awgn_passband(frame: torch.Tensor, sigma: float, delay: int,
                  buffer_len: int, generator: torch.Generator) -> torch.Tensor:
    """Place frame [B, n] into a [B, buffer_len] capture buffer at `delay`
    and add white noise of std `sigma` everywhere (reference
    apply_with_delay). The JAX function's fill="signal" (used by the BER
    harness) is ported with it (ROADMAP.md §1, item 12)."""
    b, n = frame.shape
    buf = sigma * torch.randn((b, buffer_len), generator=generator,
                              dtype=frame.dtype, device=frame.device)
    buf[:, delay:delay + n] += frame
    return buf


def sigma_for_esn0(esn0_db: float) -> float:
    """OFDM convention (reference passband_test_EsN0): per-real-sample noise
    std 10^(-EsN0/20) / sqrt(2)."""
    return 10 ** (-esn0_db / 20.0) / math.sqrt(2.0)


def sigma_for_channel_snr(frame, snr_db: float, fs: float,
                          bandwidth: float) -> float:
    """MFSK convention (reference telecom_system.cc:271-288): the noise std
    for which the in-band SNR P_signal / (P_noise * bandwidth / f_nyquist)
    is snr_db. frame: one passband frame (numpy or a tensor on any
    device); its power is taken in float64."""
    if isinstance(frame, torch.Tensor):
        p_sig = float(torch.mean(frame.double() ** 2))
    else:
        p_sig = float(np.mean(np.asarray(frame, np.float64) ** 2))
    sigma = math.sqrt(2.0 * p_sig * (fs / 2.0)
                      / (10 ** (snr_db / 10.0) * bandwidth))
    return sigma / math.sqrt(2.0)


def apply_cfo(pb: torch.Tensor, fs: float, fc: float,
              offset_hz: float) -> torch.Tensor:
    """Shift the carrier of a real passband [..., n] by offset_hz (rounded
    to an FFT bin): positive frequencies move up by the offset, negative
    ones down, so the signal stays real (the reference's -f flag)."""
    n = pb.shape[-1]
    x = torch.fft.fft(pb, dim=-1)
    pos = torch.fft.fftfreq(n, 1 / fs, device=pb.device) > 0
    k = int(round(offset_hz * n / fs))
    xs = torch.where(pos, torch.roll(x, k, dims=-1),
                     torch.roll(x, -k, dims=-1))
    return torch.fft.ifft(xs, dim=-1).real


def multipath(pb: torch.Tensor, taps_delay_samples,
              taps_gain) -> torch.Tensor:
    """Static multipath: the sum of copies of pb [..., n] delayed by
    taps_delay_samples and scaled by taps_gain."""
    n = pb.shape[-1]
    out = torch.zeros_like(pb)
    for d, a in zip(taps_delay_samples, taps_gain):
        out = out + a * torch.nn.functional.pad(pb, (d, 0))[..., :n]
    return out


def _hilbert(x: np.ndarray) -> np.ndarray:
    """Analytic signal via FFT (host)."""
    n = x.shape[-1]
    xf = np.fft.fft(x, axis=-1)
    h = np.zeros(n)
    h[0] = 1
    if n % 2 == 0:
        h[n // 2] = 1
        h[1: n // 2] = 2
    else:
        h[1: (n + 1) // 2] = 2
    return np.fft.ifft(xf * h, axis=-1)


def _fading_process(n: int, fs: float, doppler_hz: float,
                    rng: np.random.Generator) -> np.ndarray:
    """Complex Gaussian fading gain [n] with a Gaussian Doppler spectrum of
    std doppler_hz (the Watterson model's shape), unit mean power:
    synthesized at a low rate, then linearly interpolated to fs."""
    fs_low = max(doppler_hz * 64.0, 8.0)
    n_low = int(np.ceil(n * fs_low / fs)) + 2
    spec_f = np.fft.fftfreq(4 * n_low, 1 / fs_low)
    shape = np.exp(-0.5 * (spec_f / max(doppler_hz, 1e-3)) ** 2)
    noise = (rng.standard_normal(4 * n_low)
             + 1j * rng.standard_normal(4 * n_low))
    proc = np.fft.ifft(np.fft.fft(noise) * shape)
    proc = proc[n_low: 2 * n_low]
    proc /= np.sqrt(np.mean(np.abs(proc) ** 2))
    t_low = np.arange(n_low) / fs_low
    t = np.arange(n) / fs
    return (np.interp(t, t_low, proc.real)
            + 1j * np.interp(t, t_low, proc.imag))


def watterson(pb, fs: float = 48000.0, delay_ms: float = 1.0,
              doppler_hz: float = 0.5, seed: int = 0) -> np.ndarray:
    """Watterson HF ionospheric channel on a real passband [n] or [B, n]
    (numpy or a tensor; float64 numpy out): two independent Rayleigh-fading
    paths of equal mean power, delay_ms apart, applied to the analytic
    signal; row i draws from numpy's default_rng(seed + 7919*i).

    CCIR 520 presets (WATTERSON_PRESETS): good = (0.5 ms, 0.1 Hz),
    moderate = (1 ms, 0.5 Hz), poor = (2 ms, 1 Hz)."""
    if isinstance(pb, torch.Tensor):
        pb = pb.detach().cpu().numpy()
    pb = np.asarray(pb, dtype=np.float64)
    squeeze = pb.ndim == 1
    if squeeze:
        pb = pb[None]
    b, n = pb.shape
    d = int(round(delay_ms * 1e-3 * fs))
    out = np.empty_like(pb)
    for i in range(b):
        rng = np.random.default_rng(seed + 7919 * i)
        xa = _hilbert(pb[i])
        h0 = _fading_process(n, fs, doppler_hz, rng) / np.sqrt(2.0)
        h1 = _fading_process(n, fs, doppler_hz, rng) / np.sqrt(2.0)
        delayed = np.concatenate([np.zeros(d, complex), xa[: n - d]])
        out[i] = np.real(h0 * xa + h1 * delayed)
    return out[0] if squeeze else out


WATTERSON_PRESETS = {
    "good": dict(delay_ms=0.5, doppler_hz=0.1),
    "moderate": dict(delay_ms=1.0, doppler_hz=0.5),
    "poor": dict(delay_ms=2.0, doppler_hz=1.0),
}
