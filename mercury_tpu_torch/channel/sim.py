"""Channel simulator: AWGN capture buffers (PyTorch port of the JAX
package's `channel/sim.py`). Noise samples come from a `torch.Generator`;
only their statistics match the JAX package, not the samples."""

from __future__ import annotations

import math

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
