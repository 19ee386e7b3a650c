"""Batched DSP primitives (PyTorch port of the JAX package's `dsp/ops.py`).

Each function computes the plain equality its JAX counterpart states; the
JAX package's matmul formulations for the TPU's matrix unit are not carried
over. Signals are [B, n] (real or complex) unless a docstring says otherwise.
"""

from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F


def _conv(x: torch.Tensor, taps: torch.Tensor, stride: int,
          pad: tuple[int, int]) -> torch.Tensor:
    """Real convolution with `taps` along the last axis of x [B, n]
    (correlation with the flipped taps, as the JAX lax.conv call)."""
    if x.is_complex():
        return torch.complex(_conv(x.real, taps, stride, pad),
                             _conv(x.imag, taps, stride, pad))
    lhs = F.pad(x.to(taps.dtype)[:, None, :], pad)
    return F.conv1d(lhs, taps.flip(0)[None, None, :], stride=stride)[:, 0]


def fir_same(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Center-aligned 'same' FIR: out[i] = sum_j h[j] x[i - j + (T-1)//2],
    zero-padded edges (reference cl_FIR::apply)."""
    ntaps = taps.shape[0]
    center = (ntaps - 1) // 2
    return _conv(x, taps, 1, (ntaps - 1 - center, center))


def fir_same_strided(x: torch.Tensor, taps: torch.Tensor,
                     stride: int) -> torch.Tensor:
    """out[m] == fir_same(x)[m*stride], for m < (n-1)//stride + 1."""
    ntaps = taps.shape[0]
    center = (ntaps - 1) // 2
    return _conv(x, taps, stride, (ntaps - 1 - center, center))


def fir_decimate_segment(seg: torch.Tensor, taps: torch.Tensor,
                         stride: int) -> torch.Tensor:
    """Decimating FIR over a pre-extracted segment: seg[k] is
    x[start - center + k]; out[m] == fir_same(x)[start + m*stride] for
    m < (len(seg) - (T-1)) // stride."""
    ntaps = taps.shape[0]
    n_out = (seg.shape[-1] - (ntaps - 1)) // stride
    return _conv(seg, taps, stride, (0, 0))[:, :n_out]


def linear_interp(x: torch.Tensor, rate: int) -> torch.Tensor:
    """Linear-interpolation upsampler [..., N] -> [..., N*rate]; the last
    input sample is extrapolated from the final two (reference
    rational_resampler INTERPOLATION)."""
    n = x.shape[-1]
    real = x.real.dtype if x.is_complex() else x.dtype
    frac = torch.arange(rate, dtype=real, device=x.device) / rate
    body = x[..., :-1, None] + (x[..., 1:, None] - x[..., :-1, None]) * frac
    body = body.reshape(*x.shape[:-1], (n - 1) * rate)
    tail_f = (rate + torch.arange(rate, dtype=real, device=x.device)) / rate
    tail = (x[..., n - 2, None]
            + (x[..., n - 1, None] - x[..., n - 2, None]) * tail_f)
    return torch.cat([body, tail], dim=-1)


def mix_to_passband(x: torch.Tensor, fs: float, fc: float, amp: float,
                    start_sample: int = 0) -> torch.Tensor:
    """Real passband from complex baseband: re*cos + im*sin at carrier fc."""
    n = x.shape[-1]
    t = start_sample + torch.arange(n, dtype=x.real.dtype, device=x.device)
    ph = (2 * math.pi * fc / fs) * t
    return x.real * amp * torch.cos(ph) + x.imag * amp * torch.sin(ph)


def mixer_table(n: int, fc: float, fs: float, device: torch.device,
                dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """The down-mixer's oscillator sqrt(2)*exp(+j*2*pi*fc/fs*i), i < n:
    float64 phase on the host, `dtype` on `device`."""
    ph = (2 * np.pi * fc / fs) * np.arange(n, dtype=np.float64)
    osc = np.sqrt(2.0) * (np.cos(ph) + 1j * np.sin(ph))
    return torch.as_tensor(osc).to(dtype).to(device)


def peak_clip(x: torch.Tensor, papr_db: float) -> torch.Tensor:
    """Clip |sample| above sqrt(mean_power * 10^(papr/10)) per row."""
    avg = torch.mean(x * x, dim=-1, keepdim=True)
    peak = torch.sqrt(avg * (10.0 ** (papr_db / 10.0)))
    return torch.minimum(torch.maximum(x, -peak), peak)


def ofdm_mod(carriers: torch.Tensor, pad_map: torch.Tensor, nfft: int,
             ngi: int) -> torch.Tensor:
    """[..., S, Nc] -> [..., S, Nfft+Ngi]: zero-pad carriers into FFT bins,
    unnormalized IFFT (ifft * Nfft), cyclic prefix prepended."""
    spec = torch.zeros((*carriers.shape[:-1], nfft), dtype=carriers.dtype,
                       device=carriers.device)
    spec[..., pad_map] = carriers
    td = torch.fft.ifft(spec, dim=-1) * nfft
    return torch.cat([td[..., nfft - ngi:], td], dim=-1)


def ofdm_demod(samples: torch.Tensor, pad_map: torch.Tensor, nfft: int,
               ngi: int) -> torch.Tensor:
    """[..., S, Nfft+Ngi] -> [..., S, Nc]: strip the GI, 1/N-normalized FFT,
    de-pad the carriers."""
    td = samples[..., ngi:ngi + nfft]
    spec = torch.fft.fft(td, dim=-1) / nfft
    return spec[..., pad_map]


# guards the fill of every cache that cached() serves: the link's nodes
# share chains and signalers across threads (ArqTcpServer drives each node
# from its own)
_CACHE_LOCK = threading.Lock()


def cached(cache: dict, key, build):
    """cache[key], made by build() on the first call only: looked up, then
    under one lock looked up again before it is built and stored, so
    threads that share the cache build each value once."""
    value = cache.get(key)
    if value is None:
        with _CACHE_LOCK:
            value = cache.get(key)
            if value is None:
                value = cache[key] = build()
    return value


# blocks inside full_fp32_matmul, and the setting they found
_PRECISION_LOCK = threading.Lock()
_precision_users = 0
_precision_saved = "highest"


@contextlib.contextmanager
def full_fp32_matmul():
    """Float32 matmuls at full precision (TF32 off) within the block, as
    JAX's Precision.HIGHEST: the receive's LS estimation operator and the
    coherent preamble re-score run on noise-dominated samples at threshold.
    The setting is process-wide, so the blocks of all threads share it:
    the first to enter saves the caller's setting and sets "highest", the
    last to leave restores it."""
    global _precision_users, _precision_saved
    with _PRECISION_LOCK:
        if _precision_users == 0:
            _precision_saved = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision("highest")
        _precision_users += 1
    try:
        yield
    finally:
        with _PRECISION_LOCK:
            _precision_users -= 1
            if _precision_users == 0:
                torch.set_float32_matmul_precision(_precision_saved)
