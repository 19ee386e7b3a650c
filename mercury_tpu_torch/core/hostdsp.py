"""Host-side (numpy, float64) reference DSP primitives.

These mirror the reference signal chain exactly and are used (a) to build
static per-mode artifacts at geometry-build time (the pre-equalization
channel probe needs a full TX->RX round trip), and (b) as an oracle in tests.
The device compute path lives in mercury_tpu_torch.dsp / .modem; this module
is never on the hot path.

Reference: source/physical_layer/ofdm.cc, fir_filter.cc.
"""

from __future__ import annotations

import numpy as np


def design_fir(sampling_frequency: float, transition_bw: float, cut_frequency: float,
               ftype: str, window: str) -> np.ndarray:
    """Windowed-sinc FIR design (reference: fir_filter.cc:45-165).

    ftype: 'lpf' or 'hpf' (spectral inversion). window: 'hamming'|'blackman'.
    """
    ntaps = int(4.0 / (transition_bw / (sampling_frequency / 2.0)))
    if ntaps % 2 == 0:
        ntaps += 1
    h = np.empty(ntaps, dtype=np.float64)
    half = ntaps // 2
    h[half] = 1.0
    i = np.arange(half)
    temp = 2 * np.pi * cut_frequency * (half - i) / sampling_frequency
    h[:half] = np.sin(temp) / temp
    h[ntaps - i - 1] = h[:half]
    h /= h.sum()
    if ftype == "hpf":
        h = -h
        h[(ntaps - 1) // 2] += 1
    if window == "hamming":
        h *= 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(ntaps) / (ntaps - 1))
    elif window == "hanning":
        h *= 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(ntaps) / (ntaps - 1))
    elif window == "blackman":
        n = np.arange(ntaps)
        h *= 0.42 - 0.5 * np.cos(2 * np.pi * n / ntaps) + 0.08 * np.cos(4 * np.pi * n / ntaps)
    return h


def fir_apply(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Center-aligned 'same' convolution (reference: fir_filter.cc:167-210)."""
    full = np.convolve(x, h)
    start = (len(h) - 1) // 2
    return full[start:start + len(x)]


def zero_pad_map(nfft: int, nc: int, start_shift: int) -> np.ndarray:
    """FFT bin index for each carrier (reference zero_padder, ofdm.cc:379-411).

    carrier j < Nc/2  -> bin j + Nfft - Nc/2   (negative frequencies)
    carrier j >= Nc/2 -> bin j - Nc/2 + start_shift (positive frequencies)
    """
    half = nc // 2
    j = np.arange(nc)
    return np.where(j < half, j + nfft - half, j - half + start_shift)


def symbol_mod(carriers: np.ndarray, nfft: int, ngi: int, start_shift: int) -> np.ndarray:
    """One OFDM symbol: zero-pad -> unnormalized IFFT -> cyclic prefix."""
    nc = carriers.shape[-1]
    spec = np.zeros(nfft, dtype=np.complex128)
    spec[zero_pad_map(nfft, nc, start_shift)] = carriers
    td = np.fft.ifft(spec) * nfft  # Mercury IFFT is unnormalized (ofdm.cc:375-376)
    return np.concatenate([td[nfft - ngi:], td])


def symbol_demod(samples: np.ndarray, nfft: int, ngi: int, nc: int, start_shift: int) -> np.ndarray:
    """GI strip -> 1/N-normalized FFT -> depad (ofdm.cc:862-867)."""
    td = samples[ngi:ngi + nfft]
    spec = np.fft.fft(td) / nfft  # Mercury FFT normalizes by 1/N (ofdm.cc:439-442)
    return spec[zero_pad_map(nfft, nc, start_shift)]


def linear_interp_x4(x: np.ndarray, rate: int) -> np.ndarray:
    """Linear interpolation resampler (reference rational_resampler INTERPOLATION,
    ofdm.cc:2278-2291). Last input sample is linearly extrapolated from the
    final two inputs."""
    n = len(x)
    out = np.empty(n * rate, dtype=x.dtype)
    j = np.arange(rate) / rate
    diff = np.diff(x)
    out[: (n - 1) * rate] = (x[:-1, None] + diff[:, None] * j[None, :]).ravel()
    # tail: interpolate_linear(in[n-2], 0, in[n-1], rate, rate+j)
    tail_j = (rate + np.arange(rate)) / rate
    out[(n - 1) * rate:] = x[n - 2] + (x[n - 1] - x[n - 2]) * tail_j
    return out


def baseband_to_passband(bb: np.ndarray, fs: float, fc: float, amp: float,
                         rate: int, start_sample: int = 0) -> np.ndarray:
    """Interpolate x rate and mix onto a real carrier (ofdm.cc:2294-2315)."""
    interp = linear_interp_x4(bb, rate)
    n = np.arange(start_sample, start_sample + len(interp))
    ph = 2 * np.pi * fc * n / fs
    return interp.real * amp * np.cos(ph) + interp.imag * amp * np.sin(ph)


def passband_to_baseband(pb: np.ndarray, fs: float, fc: float, amp: float,
                         decim: int, fir: np.ndarray) -> np.ndarray:
    """IQ mix -> FIR -> decimate (ofdm.cc:2316-2339)."""
    n = np.arange(len(pb))
    ph = 2 * np.pi * fc * n / fs
    iq = pb * amp * (np.cos(ph) + 1j * np.sin(ph))
    filtered = fir_apply(iq, fir)
    return filtered[::decim]


def peak_clip(x: np.ndarray, papr_db: float) -> np.ndarray:
    """Clip real passband samples above sqrt(avg_power * 10^(papr/10))
    (ofdm.cc:1565-1592)."""
    avg = np.mean(x ** 2)
    peak = np.sqrt(avg * 10 ** (papr_db / 10.0))
    return np.clip(x, -peak, peak)
