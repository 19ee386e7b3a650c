"""Synchronization: Schmidl-Cox time sync, known-preamble matched filter,
the coherent whole-buffer scan and pilot-lattice arbitration of the deep
acquisition, Moose fine CFO, and the MFSK preamble and ACK/BREAK pattern
metrics (PyTorch port of the JAX package's `modem/sync.py`).

The Schmidl-Cox window sums are prefix-sum differences (cumsum, then
difference, as the JAX package computes them off the TPU); the
matched-filter scores go through `dsp.kernels.deep_mf_score` and
`deep_mf_max`, the pilot scores through `dsp.kernels.pilot_cand_score`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mercury_tpu_torch.core.geometry import MfskParams, ModeGeometry
from mercury_tpu_torch.dsp import kernels


def _comb(prefix: torch.Tensor, n_sections: int, stride: int,
          out_len: int) -> torch.Tensor:
    """C[i] = sum_{l<n_sections} prefix[i + l*stride], for i < out_len."""
    acc = prefix[..., :out_len]
    for l in range(1, n_sections):
        acc = acc + prefix[..., l * stride: l * stride + out_len]
    return acc


def _box_sum(x: torch.Tensor, length: int, n_out: int,
             stride: int) -> torch.Tensor:
    """S[j] = sum_{k<length} x[..., j*stride + k] for j < n_out."""
    c = torch.cumsum(x, dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    idx0 = stride * torch.arange(n_out, device=x.device)
    return c[..., length:][..., idx0] - c[..., idx0]


def schmidl_cox_metric(bb: torch.Tensor, geom: ModeGeometry, decim: int = 1,
                       scan: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized Schmidl-Cox metric and coarse CFO (Hz) for every candidate
    start: bb [B, n] at the interp rate / decim -> ([B, n_scan], [B, n_scan]);
    candidate i is interp-rate offset i*decim*scan. GI-lag and half-symbol
    lag correlations (|.| per lag type) summed over the preamble symbols,
    normalized by sqrt(norm_a*norm_b), with the reference's 1e-3 energy gate
    plus a -20 dB gate relative to the strongest window."""
    r = geom.interp // decim
    if r * decim != geom.interp:
        raise ValueError("decim must divide the interpolation rate")
    nfft_r, ngi_r = geom.nfft * r, geom.ngi * r
    half_r = (geom.nfft // 2) * r
    s = nfft_r + ngi_r
    lp = geom.preamble_nsymb
    n = bb.shape[-1]
    n_cand = max(n - lp * s, 1)
    if scan != 1 and not (s % scan == 0 and ngi_r % scan == 0
                          and nfft_r % scan == 0 and half_r % scan == 0):
        raise ValueError(f"scan {scan} must divide every window offset")
    n_scan = -(-n_cand // scan)
    s_c = s // scan

    p1 = bb[..., :-nfft_r] * torch.conj(bb[..., nfft_r:])
    p2 = bb[..., :-half_r] * torch.conj(bb[..., half_r:])
    e = bb.real ** 2 + bb.imag ** 2
    cs = (lp - 1) * s // scan
    b1 = _box_sum(p1, ngi_r, n_scan + cs, scan)
    b2 = _box_sum(p2, half_r, n_scan + cs + ngi_r // scan, scan)
    ea = _box_sum(e, ngi_r + half_r, n_scan + cs, scan)
    eb1 = _box_sum(e, ngi_r, n_scan + cs + nfft_r // scan, scan)
    eb2 = _box_sum(e, half_r, n_scan + cs + (ngi_r + half_r) // scan, scan)

    gi_c = _comb(b1, lp, s_c, n_scan)
    half_c = _comb(b2[..., ngi_r // scan:], lp, s_c, n_scan)
    norm_a = _comb(ea, lp, s_c, n_scan)
    norm_b = (_comb(eb1[..., nfft_r // scan:], lp, s_c, n_scan)
              + _comb(eb2[..., (ngi_r + half_r) // scan:], lp, s_c, n_scan))
    corr = torch.abs(gi_c) + torch.abs(half_c)
    denom = torch.sqrt(torch.clamp(norm_a * norm_b, min=1e-30))
    floor = torch.clamp(1e-2 * torch.amax(norm_a, dim=-1, keepdim=True),
                        min=1e-3)
    metric = torch.where((norm_a < floor) | (norm_b < floor), 0.0,
                         corr / denom)
    # half-symbol lag phase -> coarse CFO, unambiguous over +-fs/Nfft; the
    # reference's conjugate-free mixer negates the textbook sign
    lag_s = (geom.nfft // 2) * geom.interp / geom.fs
    cfo = torch.atan2(half_c.imag, half_c.real) / (2 * math.pi * lag_s)
    return metric, cfo


def topk_pooled(score: torch.Tensor, start, topn: int, pool_w: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-N peaks of score [..., n_cand] with plateau suppression: max-pool
    into pool_w-wide windows first so the N nominees are distinct peaks.
    Returns (delay [..., N] = start + offset, score [..., N]). Ties keep the
    lower index first, as lax.top_k does (a stable descending sort: gated
    silent windows score exactly 0)."""
    n_cand = score.shape[-1]
    n_pool = -(-n_cand // pool_w)
    sp = torch.nn.functional.pad(score, (0, n_pool * pool_w - n_cand),
                                 value=-math.inf)
    sp = sp.reshape(*score.shape[:-1], n_pool, pool_w)
    pooled = torch.amax(sp, dim=-1)
    inner = torch.argmax(sp, dim=-1)
    k = min(topn, n_pool)
    top_s, top_i = torch.sort(pooled, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[..., :k], top_i[..., :k]
    off = top_i * pool_w + torch.gather(inner, -1, top_i)
    if isinstance(start, torch.Tensor) and start.ndim:
        start = start.reshape(start.shape + (1,) * (off.ndim - start.ndim))
    return off + start, top_s


def coherent_scan_max(seg: torch.Tensor, bank: torch.Tensor, window: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(smax [B, n_cand], sarg [B, n_cand] int64): bank_scores of bank
    [A, Lp, S] max-combined over the hypothesis axis, first a on ties (the
    reduction runs inside the `deep_mf_max` kernel on the card)."""
    return kernels.deep_mf_max(seg, bank, window)


def pilot_rescore(bb_ts: torch.Tensor, cand_delay: torch.Tensor,
                  cand_fidx: torch.Tensor, bank: torch.Tensor, mf_s: int,
                  ts_dec: int, pre_span: int,
                  prepared: tuple[torch.Tensor, torch.Tensor] | None = None
                  ) -> torch.Tensor:
    """Pilot-lattice scores [B, M] of candidate frame starts: bb_ts [B, n_ts]
    base-rate TS baseband, cand_delay [B, M] interp-rate frame starts,
    cand_fidx [B, M] CFO-grid rows of bank [F, Nsymb, S_d] (pilot-only
    symbol templates at mf_d = mf_s*ts_dec rate, rotated in local symbol
    time), pre_span the preamble length in interp samples, prepared the
    bank's kernels.pilot_bank where the caller keeps it. Each symbol is
    correlated coherently, magnitudes summed over symbols; the silence floor
    is the XLA path's (mean energy of the segments scored)."""
    _, nsym, s_d = bank.shape
    bb_dec = bb_ts[:, ::mf_s]
    idx0 = torch.clamp(torch.div(cand_delay + pre_span, ts_dec * mf_s,
                                 rounding_mode="floor"),
                       0, max(bb_dec.shape[-1] - nsym * s_d, 0))
    return kernels.pilot_cand_score(bb_dec, idx0, cand_fidx, bank, prepared)


def bank_scores(seg: torch.Tensor, bank: torch.Tensor,
                window: int) -> torch.Tensor:
    """Normalized matched-filter scores of bank [A, Lp, S] against seg
    [B, L] at every lag 0..2*window -> [B, A, 2*window+1] (sum over the
    preamble symbols, not yet divided by Lp)."""
    nfft = 1
    while nfft < seg.shape[-1]:
        nfft *= 2
    return kernels.deep_mf_score(seg, bank, window, nfft)


def matched_filter_refine_bank(seg: torch.Tensor, start: torch.Tensor,
                               bank: torch.Tensor, window: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best lag per (row, template variant): seg [B, 2*window + Lp*S],
    start [B] absolute offset of seg[0], bank [A, Lp, S] ->
    (delay [B, A] = start + argmax lag, score [B, A] = best score / Lp)."""
    lp = bank.shape[1]
    score = bank_scores(seg, bank, window)
    best = torch.argmax(score, dim=-1)                         # [B, A]
    delay = start[:, None] + best
    return delay, torch.gather(score, -1, best[..., None])[..., 0] / lp


def moose_cfo(frame_decim: torch.Tensor, geom: ModeGeometry,
              pad_map: torch.Tensor) -> torch.Tensor:
    """Fine fractional CFO (Hz) from the preamble half-symbol repetition
    (reference carrier_sampling_frequency_sync, ofdm.cc:540-595):
    frame_decim [B, >= preamble_nsymb*Nofdm] decimated baseband starting at
    the frame -> [B]."""
    nfft, ngi, nc = geom.nfft, geom.ngi, geom.nc
    nsym = max(geom.preamble_nsymb // 2, 1)
    subc = geom.bandwidth / nc
    mul = torch.zeros(frame_decim.shape[:-1], dtype=frame_decim.dtype,
                      device=frame_decim.device)
    for j in range(nsym):
        base = ngi + j * (nfft + ngi)
        h1 = frame_decim[..., base: base + nfft // 2]
        h2 = frame_decim[..., base + nfft // 2: base + nfft]
        d1 = (torch.fft.fft(torch.cat([h1, h1], -1), dim=-1) / nfft)[..., pad_map]
        d2 = (torch.fft.fft(torch.cat([h2, h2], -1), dim=-1) / nfft)[..., pad_map]
        mul = mul + torch.sum(torch.conj(d2) * d1, dim=-1)
    angle = torch.atan2(mul.imag, mul.real)
    return (angle / math.pi) * subc


def _symbol_energy(bb: torch.Tensor, geom: ModeGeometry, decim: int
                   ) -> torch.Tensor:
    """Carrier energies [B, S, Nc] of the symbol-aligned windows of bb
    [B, n] (interp rate / decim): decimate to the base rate, frame into
    Nofdm-sample symbols, strip the GI, FFT / Nfft, take the carriers."""
    r = geom.interp // decim
    if r * decim != geom.interp:
        raise ValueError("decim must divide the interpolation rate")
    nofdm, ngi, nfft = geom.nofdm, geom.ngi, geom.nfft
    buffer_nsymb = bb.shape[-1] // (nofdm * r)
    dec = bb[..., ::r][..., : buffer_nsymb * nofdm]
    sym = dec.reshape(*bb.shape[:-1], buffer_nsymb, nofdm)[..., ngi: ngi + nfft]
    spec = torch.fft.fft(sym, dim=-1) / nfft
    pad_map = torch.as_tensor(np.asarray(geom.pad_map), device=bb.device)
    return torch.abs(spec[..., pad_map]) ** 2


def mfsk_sync_metric(bb: torch.Tensor, geom: ModeGeometry,
                     decim: int = 1) -> torch.Tensor:
    """MFSK preamble tone correlation per symbol-aligned offset (reference
    time_sync_mfsk, ofdm.cc:1969-2063): bb [B, n] at interp rate / decim ->
    metric [B, n_cand]; candidate s is the frame start s*Nofdm*interp. Each
    preamble symbol p scores the energy share of its tone (summed over the
    streams) in symbol s + p."""
    p = geom.mfsk
    energy = _symbol_energy(bb, geom, decim)                   # [B, S, Nc]
    lp = min(geom.preamble_nsymb, len(p.preamble_tones))
    n_cand = energy.shape[-2] - geom.preamble_nsymb + 1
    e_total = torch.sum(energy, dim=-1)
    met = torch.zeros((*bb.shape[:-1], n_cand), dtype=energy.dtype,
                      device=bb.device)
    for pp in range(geom.preamble_nsymb):
        tone = int(p.preamble_tones[pp % lp])
        e_t = sum(energy[..., int(off) + tone] for off in p.stream_offsets)
        ratio = torch.where(e_total > 0,
                            e_t / torch.clamp(e_total, min=1e-30), 0.0)
        met = met + ratio[..., pp: pp + n_cand]
    return met


def pattern_detect_metric(bb: torch.Tensor, geom: ModeGeometry,
                          tones: np.ndarray, mfsk_params: MfskParams = None,
                          decim: int = 1
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """ACK/BREAK tone-pattern detection (reference detect_ack_pattern,
    ofdm.cc:2067-2186): bb [B, n] at interp rate / decim (the pattern
    detector passes the base-rate baseband, decim = interp). Per
    symbol-aligned window, a pattern position matches where its expected
    hopped tone is the peak of some stream's band; the metric sums
    E_target / E_total over the matched positions. -> (metric [B, n_cand],
    matched [B, n_cand]), zeros [B, 1] when the buffer holds no window."""
    p = mfsk_params if mfsk_params is not None else geom.mfsk
    nsymb_pat = p.ack_pattern_nsymb
    r = geom.interp // decim
    n_cand = bb.shape[-1] // (geom.nofdm * r) - nsymb_pat + 1
    if n_cand < 1:
        z = torch.zeros((*bb.shape[:-1], 1), device=bb.device)
        return z, z
    energy = _symbol_energy(bb, geom, decim)                   # [B, S, Nc]
    e_total = torch.clamp(torch.sum(energy, dim=-1), min=1e-30)
    peaks = [torch.amax(energy[..., int(off): int(off) + p.m], dim=-1)
             for off in p.stream_offsets]
    met = torch.zeros((*bb.shape[:-1], n_cand), device=bb.device)
    cnt = torch.zeros((*bb.shape[:-1], n_cand), device=bb.device)
    for pos in range(nsymb_pat):
        actual = (int(tones[pos % len(tones)]) + pos * p.tone_hop_step) % p.m
        e_this = [energy[..., int(off) + actual] for off in p.stream_offsets]
        hit = e_this[0] >= peaks[0]
        for e_s, peak in zip(e_this[1:], peaks[1:]):
            hit = hit | (e_s >= peak)
        contrib = torch.where(hit, sum(e_this) / e_total, 0.0)
        met = met + contrib[..., pos: pos + n_cand]
        cnt = cnt + hit[..., pos: pos + n_cand]
    return met, cnt
