"""PSK/QAM mapping, max-log soft demapping and the full log-MAP demapper
with bit priors (PyTorch port of the JAX package's `modem/psk.py`;
reference psk.cc:259-326)."""

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


def demod_full(symbols: torch.Tensor, constellation: torch.Tensor,
               variance: torch.Tensor,
               la: torch.Tensor | None = None) -> torch.Tensor:
    """Full log-MAP LLRs (log P(bit=0)/P(bit=1), a log-sum-exp over the
    constellation instead of demod's max-log), with optional per-bit priors
    la [B, n, log2M] (MSB first) folded in as symbol priors: the demapper
    half of BICM-ID. symbols [B, n], variance [B] -> [B, n*log2M]; with la
    the result is extrinsic (la subtracted)."""
    m = constellation.shape[0]
    nbits = m.bit_length() - 1
    d = torch.abs(symbols[..., None] - constellation) ** 2       # [B, n, M]
    s = -d * (1.0 / variance)[:, None, None]
    idx = torch.arange(m, device=symbols.device)
    shift = torch.arange(nbits - 1, -1, -1, device=symbols.device)
    # bit_tab[k, j]: bit j (MSB first) of constellation index k
    bit_tab = ((idx[:, None] >> shift[None]) & 1).to(s.dtype)    # [M, nbits]
    if la is not None:
        # symmetric prior score: +la/2 where the bit is 0, -la/2 where 1
        s = s + la @ (0.5 - bit_tab).T
    llrs = []
    for j in range(nbits):
        zero = bit_tab[:, j] == 0
        s0 = torch.logsumexp(torch.where(zero, s, -torch.inf), dim=-1)
        s1 = torch.logsumexp(torch.where(zero, -torch.inf, s), dim=-1)
        llrs.append(s0 - s1)
    llr = torch.stack(llrs, dim=-1)                              # [B, n, nbits]
    if la is not None:
        llr = llr - la
    return llr.reshape(*symbols.shape[:-1], -1)
