"""PSK/QAM mapping and max-log soft demapping (PyTorch port of
the JAX package's `modem/psk.py`; reference psk.cc:259-326)."""

from __future__ import annotations

import torch


def mod(bits: torch.Tensor, constellation: torch.Tensor) -> torch.Tensor:
    """bits [..., n*log2M] in {0,1} -> symbols [..., n], MSB-first groups."""
    m = constellation.shape[0]
    nbits = m.bit_length() - 1
    groups = bits.reshape(*bits.shape[:-1], -1, nbits).long()
    powers = 2 ** torch.arange(nbits - 1, -1, -1, device=bits.device)
    idx = torch.sum(groups * powers, dim=-1)
    return constellation[idx]


def demod(symbols: torch.Tensor, constellation: torch.Tensor,
          variance: torch.Tensor) -> torch.Tensor:
    """Max-log LLRs scaled by 1/variance: symbols [B, n], variance [B] ->
    [B, n*log2M], MSB first (output bit j is constellation index bit
    log2M-1-j, the TX grouping)."""
    m = constellation.shape[0]
    nbits = m.bit_length() - 1
    d = torch.abs(symbols[..., None] - constellation) ** 2       # [B, n, M]
    idx = torch.arange(m, device=symbols.device)
    llrs = []
    for k in range(nbits):               # k = mask bit position (LSB..MSB)
        one = ((idx >> k) & 1) == 1
        d0 = torch.amin(torch.where(one, torch.inf, d), dim=-1)
        d1 = torch.amin(torch.where(one, d, torch.inf), dim=-1)
        llrs.append(d1 - d0)
    llr = torch.stack(llrs[::-1], dim=-1)                        # [B, n, nbits]
    llr = llr * (1.0 / variance)[:, None, None]
    return llr.reshape(*symbols.shape[:-1], -1)
