"""Non-coherent MFSK of the ROBUST modes (PyTorch port of the JAX package's
`modem/mfsk.py`; reference mfsk.cc).

One tone per stream and symbol over the OFDM carriers, coprime tone
hopping, Gray bit mapping; energy-detection soft demod with the noise
estimated from the carriers outside every stream's band and the LLRs
clipped at +-clamp. The preamble and ACK/BREAK tone grids are host numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mercury_tpu_torch.core.geometry import MfskParams


def _gray_decode_matrix(nbits: int) -> np.ndarray:
    """index-from-bits helper: bits (MSB first) -> gray-decoded tone index."""
    idx = np.arange(1 << nbits)
    b = idx.copy()
    for shift in range(1, nbits):
        b ^= idx >> shift
    return b


def mod(bits: torch.Tensor, p: MfskParams, nc: int, nsymb: int,
        dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """bits [..., nsymb*nstreams*nbits] -> carrier grid [..., nsymb, nc]
    (reference cl_mfsk::mod, mfsk.cc:251-302): amplitude sqrt(Nc/nstreams)
    on each stream's tone, hopped to (tone + s*hop) % M in symbol s."""
    dev = bits.device
    groups = bits.reshape(*bits.shape[:-1], nsymb, p.nstreams, p.nbits).long()
    powers = 2 ** torch.arange(p.nbits - 1, -1, -1, device=dev)
    raw_idx = torch.sum(groups * powers, dim=-1)              # [..., S, st]
    tone = torch.as_tensor(_gray_decode_matrix(p.nbits), device=dev)[raw_idx]
    hop = torch.as_tensor((np.arange(nsymb) * p.tone_hop_step) % p.m,
                          device=dev)
    actual = (tone + hop[:, None]) % p.m
    grid = torch.zeros((*bits.shape[:-1], nsymb, nc), dtype=dtype, device=dev)
    amp = math.sqrt(nc / p.nstreams)
    for st in range(p.nstreams):
        off = int(p.stream_offsets[st])
        oh = torch.nn.functional.one_hot(actual[..., st], p.m)
        grid[..., off:off + p.m] += oh.to(dtype) * amp
    return grid


def preamble_grid(p: MfskParams, nc: int, pre_nsymb: int) -> np.ndarray:
    """Known preamble tones, same tone in every stream (mfsk.cc:172-193)."""
    amp = np.sqrt(nc / p.nstreams)
    grid = np.zeros((pre_nsymb, nc), dtype=np.complex128)
    for s in range(pre_nsymb):
        tone = int(p.preamble_tones[s % len(p.preamble_tones)])
        for st in range(p.nstreams):
            grid[s, int(p.stream_offsets[st]) + tone] = amp
    return grid


def pattern_grid(p: MfskParams, nc: int, tones: np.ndarray) -> np.ndarray:
    """ACK/BREAK tone pattern: 16 symbols with hopping (mfsk.cc:196-247)."""
    amp = np.sqrt(nc / p.nstreams)
    nsymb = p.ack_pattern_nsymb
    grid = np.zeros((nsymb, nc), dtype=np.complex128)
    for s in range(nsymb):
        base = int(tones[s % len(tones)])
        actual = (base + s * p.tone_hop_step) % p.m
        for st in range(p.nstreams):
            grid[s, int(p.stream_offsets[st]) + actual] = amp
    return grid


def demod(fft_grid: torch.Tensor, p: MfskParams, nc: int, nsymb: int,
          soft: str = "maxlog", exp_scale: float = 1.0, clamp: float = 5.0,
          noise_pool: bool = False) -> torch.Tensor:
    """Energy-detection soft demod: carrier grid [..., nsymb, nc] -> LLRs
    [..., nsymb*nstreams*nbits] (reference cl_mfsk::demod, mfsk.cc:305-390).

    The noise variance is the mean energy of the carriers outside every
    stream's band, per symbol, or pooled over the frame's symbols
    (noise_pool). The likelihood exponent is exp_scale * E / (2 sigma^2).
    soft="maxlog" takes, per bit, the difference of the largest tone
    energies with the bit 0 and 1; soft="sumexp" the difference of their
    log-sum-exps (the noncoherent marginalization over the tones)."""
    energy = torch.abs(fft_grid) ** 2                          # [..., S, Nc]
    band_start = int(p.stream_offsets[0])
    band_end = int(p.stream_offsets[-1]) + p.m
    k = np.arange(nc)
    noise_mask = (k < band_start) | (k >= band_end)
    n_noise = int(noise_mask.sum())
    if n_noise > 0:
        mask = torch.as_tensor(noise_mask, device=energy.device)
        noise_var = torch.sum(torch.where(mask, energy, 0.0), dim=-1) / n_noise
    else:
        noise_var = torch.full(energy.shape[:-1], 1e-30, dtype=energy.dtype,
                               device=energy.device)
    if noise_pool:
        noise_var = torch.mean(noise_var, dim=-1, keepdim=True).expand(
            *noise_var.shape[:-1], nsymb)
    noise_var = torch.clamp(noise_var, min=1e-30)
    llr_scale = float(np.float32(exp_scale)) / (2.0 * noise_var)   # [..., S]

    hop = (np.arange(nsymb) * p.tone_hop_step) % p.m
    gray_of = np.arange(p.m) ^ (np.arange(p.m) >> 1)
    # [nbits, M]: the tones whose Gray label has bit k (MSB first) set
    ones = torch.as_tensor(
        ((gray_of[None] >> (p.nbits - 1 - np.arange(p.nbits))[:, None]) & 1)
        == 1, device=energy.device)
    # reverse hopping: E[data tone m] = E_raw[(m + hop) % M]
    gather = torch.as_tensor((np.arange(p.m)[None, :] + hop[:, None]) % p.m,
                             device=energy.device)            # [S, M]
    llr_streams = []
    for st in range(p.nstreams):
        off = int(p.stream_offsets[st])
        e_raw = energy[..., off:off + p.m]                     # [..., S, M]
        e = torch.gather(e_raw, -1, gather.expand(e_raw.shape))
        if soft == "sumexp":
            ce = (e * llr_scale[..., None])[..., None, :]      # [..., S, 1, M]
            l1 = torch.logsumexp(torch.where(ones, ce, -math.inf), dim=-1)
            l0 = torch.logsumexp(torch.where(ones, -math.inf, ce), dim=-1)
            bit_llr = l0 - l1                                  # [..., S, nbits]
        else:
            e4 = e[..., None, :]
            e1 = torch.amax(torch.where(ones, e4, -math.inf), dim=-1)
            e0 = torch.amax(torch.where(ones, -math.inf, e4), dim=-1)
            bit_llr = (e0 - e1) * llr_scale[..., None]
        llr_streams.append(bit_llr)
    llr = torch.stack(llr_streams, dim=-2)                     # [..., S, st, nbits]
    llr = torch.clamp(llr, -float(clamp), float(clamp))
    return llr.reshape(*fft_grid.shape[:-2], -1)
