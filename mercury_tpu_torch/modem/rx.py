"""Receive chain: passband capture buffer -> decoded payload (PyTorch port of
the OFDM path of `RxChain` in the JAX package's `modem/rx.py`).

Stages, in order: mixer + strided time-sync FIR (CUDA kernel
`mix_fir_decimate`), Schmidl-Cox top-K candidates, then the delay and coarse
CFO: matched-filter refinement over (candidate x CFO alias) and, on the
deep-sync modes, a noncoherent whole-buffer known-preamble scan (both CUDA
kernel `deep_mf_score`); or, on CONFIG_0, the coherent whole-buffer scan
(`deep_mf_max`) whose top candidates the pilot lattice arbitrates
(`pilot_cand_score`). Then frame extraction through the data FIR
(`mix_fir_decimate` with per-row starts), Moose CFO and the pilot-variance
pick among CFO hypotheses, FFT demod, ramp-aware LS channel estimate, max-log
demap, layered LDPC and the CRC16 check; on CONFIG_0 a batch with a failed
row is decoded once more at the runner-up candidate.

JAX's jit/vmap/lax control flow becomes eager code over a written-out batch
axis. Float32 matmuls run at full precision (no TF32) inside `receive`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from mercury_tpu_torch.convert import resolve_device, rx_state_from_numpy
from mercury_tpu_torch.core import crc as crc_mod
from mercury_tpu_torch.core import hostdsp
from mercury_tpu_torch.core.geometry import ModeGeometry
from mercury_tpu_torch.core.modes import ZERO_FORCE
from mercury_tpu_torch.dsp import kernels, ops
from mercury_tpu_torch.fec.ldpc import LayeredDecoder
from mercury_tpu_torch.modem import psk, sync

PILOT_BOOST = 1.33
DEEP_GRID_HZ = 30.0      # whole-buffer scan CFO grid ("pruned" profile)
DEEP_COH_GRID_HZ = 4.0   # coherent whole-buffer scan CFO grid (CONFIG_0)
DEEP_PIL_TOPM = 32       # coherent-scan nominees the pilot lattice re-scores


@dataclass
class RxResult:
    """Per-frame decode outcome (all tensors batched)."""
    payload: torch.Tensor       # [B, frame_bytes] uint8
    crc_ok: torch.Tensor        # [B] bool (CRC passed, not all-zeros)
    delay: torch.Tensor         # [B] int64 frame start (interp samples)
    freq_offset: torch.Tensor   # [B] float32 Hz
    snr_db: torch.Tensor        # [B] float32
    iters: torch.Tensor         # [B] int64 LDPC sweeps
    sync_metric: torch.Tensor   # [B] float32 coarse sync correlation
    mean_h: torch.Tensor        # [B] float32 mean |H| at the pilots


def host_constants(geom: ModeGeometry, deep_sync: bool
                   ) -> tuple[dict[str, np.ndarray], dict]:
    """The receive constants of an OFDM LS-estimator mode, built on the host
    exactly as the JAX RxChain builds them: (arrays by buffer name, scalars
    of the ramp-aware LS estimator). The pilot-only symbol waveforms exist
    with deep sync only, as in the JAX chain."""
    g = geom
    pilot_cells = np.asarray(g.pilot_cells)
    arrays = {
        "_fir_ts": g.fir_rx_ts, "_fir_data": g.fir_rx_data,
        "_pad_map": g.pad_map, "_bit_iperm": g.bit_iperm,
        "_tf_iperm": g.tf_iperm, "_data_cells": g.data_cells,
        "_pilot_cells": pilot_cells,
        "_dispersal": g.dispersal[: g.n_real],
        "_pilot_seq": np.asarray(g.pilot_seq, np.complex64),
        "_est_op": g.est_op, "_const": np.asarray(g.constellation, np.complex64),
    }
    # ramp-aware LS: same-symbol carrier-adjacent pilot pairs give the
    # timing-ramp slope; signed FFT bins keep the ramp continuous mid-band
    s_of_r = pilot_cells // g.nc
    c_of_r = pilot_cells % g.nc
    pm = np.asarray(g.pad_map).astype(np.float64)
    pm_signed = np.where(pm >= g.nfft / 2, pm - g.nfft, pm)
    bins = pm_signed[c_of_r]
    pair_a, pair_b, dbins = [], [], []
    for s_row in np.unique(s_of_r):
        kk = np.nonzero(s_of_r == s_row)[0]
        kk = kk[np.argsort(bins[kk])]
        for i in range(len(kk) - 1):
            pair_a.append(kk[i + 1])
            pair_b.append(kk[i])
            dbins.append(bins[kk[i + 1]] - bins[kk[i]])
    dbins = np.asarray(dbins)
    dmin = dbins.min()
    keep = dbins == dmin
    arrays["_ramp_a"] = np.asarray(pair_a)[keep]
    arrays["_ramp_b"] = np.asarray(pair_b)[keep]
    scalars = {"ramp_dbin": float(dmin), "ramp2_dbin": None,
               "ramp_max": float(2 * np.pi * 10.0 / g.nfft)}
    # long-lag refinement pairs: the most frequent exact bin lag in
    # (2*dmin, 12]
    la, lb, ld = [], [], []
    for s_row in np.unique(s_of_r):
        kk = np.nonzero(s_of_r == s_row)[0]
        bb_s = bins[kk]
        for i in range(len(kk)):
            for j2 in range(len(kk)):
                d = bb_s[i] - bb_s[j2]
                if 2 * dmin < d <= 12.0:
                    la.append(kk[i])
                    lb.append(kk[j2])
                    ld.append(d)
    if ld:
        ld = np.asarray(ld)
        vals, cnts = np.unique(ld, return_counts=True)
        l2 = vals[np.argmax(cnts)]
        sel = ld == l2
        arrays["_ramp2_a"] = np.asarray(la)[sel]
        arrays["_ramp2_b"] = np.asarray(lb)[sel]
        scalars["ramp2_dbin"] = float(l2)
    arrays["_pil_bins"] = np.asarray(bins, np.float32)
    arrays["_cell_bins"] = pm_signed[
        np.arange(g.nsymb * g.nc) % g.nc].astype(np.float32)
    # CFO-hypothesis selection: per-symbol partial DFT of the pilot bins,
    # slot map back to pilot_cells order, pilot rows of the LS operator
    s_of = pilot_cells // g.nc
    c_of = pilot_cells % g.nc
    k_bins = np.asarray(g.pad_map)[c_of].astype(np.float64)
    t_fft = np.arange(g.nfft, dtype=np.float64)
    rows = np.exp(-2j * np.pi * np.outer(k_bins, t_fft) / g.nfft) / g.nfft
    maxp = int(np.bincount(s_of, minlength=g.nsymb).max())
    pil_op = np.zeros((g.nsymb, maxp, g.nfft), np.complex128)
    pil_slot = np.zeros(len(s_of), np.int64)
    fill = np.zeros(g.nsymb, np.int64)
    for i, s in enumerate(s_of):
        pil_op[s, fill[s]] = rows[i]
        pil_slot[i] = s * maxp + fill[s]
        fill[s] += 1
    arrays["_pil_dft_op"] = np.asarray(pil_op, np.complex64)
    arrays["_pil_slot"] = pil_slot
    arrays["_est_pil_op"] = np.asarray(g.est_op)[pilot_cells].astype(np.float32)
    # known-preamble matched-filter templates (interp-rate waveforms)
    pre_vals = g.preamble_vals
    if g.pre_eq is not None:
        pre_vals = pre_vals * g.pre_eq[None, :]
    td = np.concatenate([hostdsp.symbol_mod(pre_vals[l], g.nfft, g.ngi, 1)
                         for l in range(g.preamble_nsymb)])
    tmpl = hostdsp.linear_interp_x4(td, g.interp)
    arrays["_mf_templates"] = np.asarray(
        tmpl.reshape(g.preamble_nsymb, g.nofdm * g.interp), np.complex64)
    if deep_sync:
        # per-symbol pilot-only waveforms for the pilot-lattice arbitration:
        # the frame grid with data cells zeroed, pre-equalized like TX
        flat_p = np.zeros(g.nsymb * g.nc, np.complex128)
        flat_p[pilot_cells] = np.asarray(g.pilot_seq)
        grid_p = flat_p.reshape(g.nsymb, g.nc)
        if g.pre_eq is not None:
            grid_p = grid_p * np.asarray(g.pre_eq)[None, :]
        td_p = np.concatenate([hostdsp.symbol_mod(grid_p[s], g.nfft, g.ngi, 1)
                               for s in range(g.nsymb)])
        tp = hostdsp.linear_interp_x4(td_p, g.interp)
        arrays["_pil_templates"] = np.asarray(
            tp.reshape(g.nsymb, g.nofdm * g.interp), np.complex64)
    a, c0 = crc_mod.crc_affine(g.frame_bytes + 2)
    arrays["_crc_a"] = a.astype(np.float32)
    arrays["_crc_c0"] = c0
    return arrays, scalars


def _cis(theta: torch.Tensor) -> torch.Tensor:
    """e^{j theta} for a real tensor."""
    return torch.complex(torch.cos(theta), torch.sin(theta))


@contextlib.contextmanager
def _full_fp32_matmul():
    """Float32 matmuls at full precision (TF32 off) within the block: the
    LS estimation operator runs on noise-dominated pilots at threshold."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _roadmap(item: int, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mercury_tpu_torch yet (ROADMAP.md §1, "
        f"item {item})")


class RxChain(nn.Module):
    """Per-mode RX program for the OFDM modes with the LS estimator.

    Options as in the JAX RxChain, with its default "wide" acquisition
    profile: the 93.75 Hz coarse-CFO alias is arbitrated by a 3-way
    matched-filter vote and 4 CFO hypotheses (cfo_range="narrow" has no
    caller and is not ported). deep_sync (auto: CONFIG_0-4) adds the
    whole-buffer known-preamble scan: noncoherent, or with deep_coherent
    (auto: CONFIG_0) the coherent scan, pilot-lattice arbitration and the
    CRC-gated rescue decode. Options and modes outside this port raise
    NotImplementedError naming their ROADMAP item.

    The chain lives on the CUDA card unless `device` names another;
    device="cpu" runs the kernels' plain versions (see
    convert.resolve_device).
    """

    def __init__(self, geom: ModeGeometry, device=None, ctrl: bool = False,
                 deep_sync: bool | None = None,
                 ldpc_algo: str = "layered", deep_profile: str = "pruned",
                 deep_coherent: bool | None = None, dd: bool | None = None,
                 bicm_iters: int | None = None, ldpc_max_iter: int = 50):
        super().__init__()
        g = geom
        device = resolve_device(device)
        if g.spec.is_mfsk or ctrl:
            raise _roadmap(11, "MFSK/ROBUST modes and ctrl frames")
        if deep_sync is None:
            deep_sync = g.spec.config <= 4
        if deep_coherent is None:
            deep_coherent = g.spec.config == 0
        if deep_profile != "pruned":
            raise _roadmap(8, f"deep_profile={deep_profile!r}")
        if g.estimator == ZERO_FORCE:
            raise _roadmap(10, "the zero-forcing estimator (CONFIG_15/16)")
        if dd is None:
            dd = len(g.constellation) >= 8
        if dd:
            raise _roadmap(9, "decision-directed re-estimation (dd=True, "
                              "default for 8PSK/16QAM)")
        if bicm_iters:
            raise _roadmap(10, "BICM-ID (bicm_iters > 0)")
        if ldpc_algo != "layered":
            raise _roadmap(10, f"ldpc_algo={ldpc_algo!r}")
        if not g.spec.amplitude_restoration:
            raise _roadmap(9, "the decision-directed MER SNR of QAM modes")
        self.geom = g
        self.deep_sync = bool(deep_sync)
        self.deep_coherent = self.deep_sync and bool(deep_coherent)
        arrays, scalars = host_constants(g, self.deep_sync)
        for name, t in rx_state_from_numpy(arrays, device).items():
            self.register_buffer(name, t)
        self.ramp_dbin = scalars["ramp_dbin"]
        self.ramp2_dbin = scalars["ramp2_dbin"]
        self.ramp_max = scalars["ramp_max"]
        self.crc_nbits = (g.frame_bytes + 2) * 8
        self.decoder = LayeredDecoder(g.spec.ldpc_rate_num, ldpc_max_iter)
        self._osc_cache: dict = {}
        self._bank_cache: dict = {}
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self._fir_ts.device

    # ------------------------------------------------------------------
    def _osc_const(self, n: int) -> torch.Tensor:
        """sqrt(2)*exp(+j*2*pi*fc/fs*i) for i < n: float64 phase on the
        host, complex64 on the device, built once per length."""
        key = (n, self.device)
        arr = self._osc_cache.get(key)
        if arr is None:
            g = self.geom
            ph = (2 * np.pi * g.fc / g.fs) * np.arange(n, dtype=np.float64)
            osc = (np.sqrt(2.0) * (np.cos(ph) + 1j * np.sin(ph))).astype(
                np.complex64)
            arr = torch.as_tensor(osc, device=self.device)
            self._osc_cache[key] = arr
        return arr

    def mix(self, pb: torch.Tensor, freq_offset=0.0) -> torch.Tensor:
        """Passband [B, n] -> complex IQ at fc + freq_offset ([B] or
        scalar), unfiltered."""
        g = self.geom
        n = pb.shape[-1]
        pb = pb.to(torch.float32)
        if isinstance(freq_offset, (int, float)) and freq_offset == 0.0:
            return pb * self._osc_const(n)
        t = torch.arange(n, dtype=torch.float32, device=pb.device)
        f = torch.as_tensor(freq_offset, dtype=torch.float32, device=pb.device)
        f = f.reshape(-1, 1) if f.ndim else f
        ph = (2 * math.pi / g.fs) * (g.fc + f) * t
        return pb * math.sqrt(2.0) * _cis(ph)

    def extract_frame_decimated_pb(self, pb: torch.Tensor, delay: torch.Tensor,
                                   n_symb: int) -> torch.Tensor:
        """Mixer + data FIR over the frame only: the decimated baseband
        [B, (n_symb + preamble)*Nofdm] of the frame starting at per-row
        `delay` (interp samples), equal to fir_same(mix(pb))[delay::interp].
        The start is clipped as the JAX chain clips its padded slice."""
        g = self.geom
        ntaps = self._fir_data.shape[0]
        center = (ntaps - 1) // 2
        frame_interp = g.nofdm * (n_symb + g.preamble_nsymb) * g.interp
        seg_len = frame_interp + ntaps - 1
        n_pad = pb.shape[-1] + center + ntaps
        start = torch.clamp(delay.long(), 0, n_pad - seg_len).contiguous()
        return kernels.mix_fir_decimate(
            pb, self._osc_const(pb.shape[-1]), self._fir_data, g.interp,
            start=start, n_out=frame_interp // g.interp,
            offset=ntaps - 1 - center)

    def demod_grid(self, frame_decim: torch.Tensor) -> torch.Tensor:
        """Decimated frame [B, (P+S)*Nofdm] -> carrier grid [B, S, Nc]."""
        g = self.geom
        b = frame_decim.shape[0]
        sym = frame_decim[:, g.preamble_nsymb * g.nofdm:].reshape(
            b, g.nsymb, g.nofdm)
        return ops.ofdm_demod(sym, self._pad_map, g.nfft, g.ngi)

    def grid_stats(self, grid: torch.Tensor):
        """AGC + ramp-aware LS channel estimate + equalization of a carrier
        grid [B, S, Nc] -> (equalized flat grid, variance, mean_h,
        var_full)."""
        b = grid.shape[0]
        flat = grid.reshape(b, -1)
        y_pil = flat[:, self._pilot_cells]
        gain = PILOT_BOOST / torch.mean(torch.abs(y_pil), dim=-1, keepdim=True)
        flat = flat * gain
        y_pil = y_pil * gain
        h_meas = y_pil / self._pilot_seq
        pa = h_meas[:, self._ramp_a]
        pb = h_meas[:, self._ramp_b]
        corr = torch.sum(pa * torch.conj(pb), dim=-1)
        # coherence shrinkage: near 1 on clean signals, near 0 where the
        # pair angle is noise
        denom = torch.sum(torch.abs(pa) * torch.abs(pb), dim=-1)
        coh = torch.abs(corr) / torch.clamp(denom, min=1e-30)
        slope = coh * torch.atan2(corr.imag, corr.real) / self.ramp_dbin
        if self.ramp2_dbin is not None:
            qa = h_meas[:, self._ramp2_a]
            qb = h_meas[:, self._ramp2_b]
            corr2 = torch.sum(qa * torch.conj(qb), dim=-1)
            corr2 = corr2 * _cis(-slope * self.ramp2_dbin)
            den2 = torch.sum(torch.abs(qa) * torch.abs(qb), dim=-1)
            coh2 = torch.abs(corr2) / torch.clamp(den2, min=1e-30)
            slope = slope + (coh2 * torch.atan2(corr2.imag, corr2.real)
                             / self.ramp2_dbin)
        slope = torch.clamp(slope, -self.ramp_max, self.ramp_max)
        y_est = y_pil * _cis(-slope[:, None] * self._pil_bins[None])
        h = torch.complex(y_est.real @ self._est_op.T,
                          y_est.imag @ self._est_op.T)
        h = h * _cis(slope[:, None] * self._cell_bins[None])
        h_pil = h[:, self._pilot_cells]
        mean_h = torch.mean(torch.abs(h_pil), dim=-1)
        eq = flat / (h / torch.clamp(torch.abs(h), min=1e-30))
        eq_pil = eq[:, self._pilot_cells]
        variance = torch.mean(torch.abs(eq_pil - self._pilot_seq) ** 2, dim=-1)
        var_full = torch.mean(torch.abs(y_pil / h_pil - self._pilot_seq) ** 2,
                              dim=-1)
        return eq, variance, mean_h, var_full

    def llr_to_payload(self, llr: torch.Tensor):
        """Deinterleaved LLRs [B, nBits] -> layered LDPC -> CRC16 check ->
        (payload [B, frame_bytes] uint8, crc_ok, iters)."""
        g = self.geom
        b = llr.shape[0]
        llr_n = torch.cat([llr[:, : g.n_real], llr[:, : g.n_virtual],
                           llr[:, g.n_real: g.n_real + g.ldpc_p]], dim=-1)
        bits, iters, _conv = self.decoder(llr_n)
        real_bits = bits[:, : g.n_real] ^ self._dispersal[None]
        all_zeros = torch.all(real_bits[:, : (g.n_real // 8) * 8] == 0, dim=-1)
        crc_bits = real_bits[:, : self.crc_nbits]
        # 0/1 products summed in float32: exact under any matmul precision
        crc = torch.remainder(crc_bits.to(torch.float32) @ self._crc_a.T,
                              2.0).long() ^ self._crc_c0[None]
        crc_ok = torch.all(crc == 0, dim=-1) & ~all_zeros
        shifts = torch.arange(8, device=llr.device)
        payload = torch.sum(real_bits[:, : g.frame_bytes * 8].reshape(b, -1, 8)
                            << shifts, dim=-1).to(torch.uint8)
        return payload, crc_ok, iters

    # ------------------------------------------------------------------
    def _rotated_bank(self, tmpl_d: torch.Tensor, freqs, mf_d: int,
                      symbol_step: int = 0):
        """[F, Lp, S] bank of decimated templates [Lp, S] rotated by
        e^{-j w_f t} (CFO hypotheses on the template side), float64 phase
        then complex64, as the JAX chain builds it on the host. t is the
        sample's time within its symbol (symbol_step 0), or its absolute
        time t = k*mf_d + l*symbol_step, which keeps the phase running from
        one symbol to the next for a coherent sum over symbols."""
        dev = tmpl_d.device
        lp, s = tmpl_d.shape
        t = (torch.arange(s, dtype=torch.float64, device=dev)[None] * mf_d
             + torch.arange(lp, dtype=torch.float64, device=dev)[:, None]
             * symbol_step)
        f = torch.as_tensor(np.asarray(freqs, np.float64), device=dev)
        rot = _cis((-(2 * np.pi / self.geom.fs) * f)[:, None, None] * t[None])
        return (tmpl_d.to(torch.complex128)[None] * rot).to(torch.complex64)

    def _coherent_banks(self, mf_d: int):
        """CONFIG_0's CFO grid [F] (+-120 Hz in 4 Hz steps) and its banks at
        mf_d: the preamble as one symbol [F, 1, Lp*S_d], rotated in absolute
        time, the pilot-only symbols [F, Nsymb, S_d], rotated in local
        symbol time, and that bank prepared for the pilot kernel
        (kernels.pilot_bank). Built once per (mf_d, device) and kept, as
        _osc_const keeps the oscillator."""
        key = (mf_d, self.device)
        banks = self._bank_cache.get(key)
        if banks is None:
            tmpl_d = self._mf_templates[:, ::mf_d]
            lp, s_d = tmpl_d.shape
            n_h = int(round(120.0 / DEEP_COH_GRID_HZ))
            grid = np.arange(-n_h, n_h + 1) * DEEP_COH_GRID_HZ
            coh = self._rotated_bank(tmpl_d, grid, mf_d,
                                     self._mf_templates.shape[1])
            pil = self._rotated_bank(self._pil_templates[:, ::mf_d], grid,
                                     mf_d)
            banks = (grid, coh.reshape(len(grid), 1, lp * s_d), pil,
                     kernels.pilot_bank(pil))
            self._bank_cache[key] = banks
        return banks

    def _coherent_acquire(self, bb_ts: torch.Tensor, mf_d: int, ts_dec: int):
        """CONFIG_0's coherent whole-buffer acquisition (mercury_tpu rx.py
        :1342-1422): the full preamble scored coherently at every lag for
        each row of a 4 Hz CFO grid, max-combined over the grid; the top
        pooled peaks re-scored against the pilot lattice. -> (delay [B],
        coarse CFO [B], runner-up delay [B] outside the winner's GI plateau,
        its CFO [B], whether a row has one [B])."""
        g = self.geom
        mf_s = mf_d // ts_dec
        lp, s_tmpl = self._mf_templates.shape
        span = lp * (s_tmpl // mf_d)
        win_g = (bb_ts.shape[-1] // mf_s - span) // 2
        seg_g = bb_ts[:, : (2 * win_g + span) * mf_s: mf_s]
        grid, bank_coh, bank_pil, pil_prep = self._coherent_banks(mf_d)
        smax, sarg = sync.coherent_scan_max(seg_g, bank_coh, win_g)
        d_lag, _ = sync.topk_pooled(smax, 0, DEEP_PIL_TOPM, 8)   # [B, M]
        f_top = torch.gather(sarg, 1, d_lag)
        d_top = d_lag * mf_d                        # interp-rate starts
        score_p = sync.pilot_rescore(bb_ts, d_top, f_top, bank_pil, mf_s,
                                     ts_dec, lp * s_tmpl, pil_prep)  # [B, M]
        grid_t = torch.as_tensor(grid, dtype=torch.float32,
                                 device=bb_ts.device)

        def pick(score):
            i = torch.argmax(score, dim=-1, keepdim=True)
            return (torch.gather(d_top, 1, i)[:, 0],
                    grid_t[torch.gather(f_top, 1, i)[:, 0]])

        delay, coarse_cfo = pick(score_p)
        far = torch.abs(d_top - delay[:, None]) > g.ngi * g.interp
        delay2, cfo2 = pick(torch.where(far, score_p, -math.inf))
        return delay, coarse_cfo, delay2, cfo2, torch.any(far, dim=-1)

    def _acquire(self, pb: torch.Tensor):
        """Coarse sync + matched-filter arbitration -> (delay [B],
        coarse CFO [B], sync metric [B], rescue). rescue is None, or on the
        coherent path (delay, coarse CFO, eligible) [B] of the runner-up
        candidate."""
        g = self.geom
        b, n = pb.shape
        dev = pb.device
        # 1) base-rate time-sync baseband: mixer + strided TS FIR in one pass
        ts_dec = g.interp
        bb_ts = kernels.mix_fir_decimate(pb, self._osc_const(n), self._fir_ts,
                                         ts_dec)
        # Schmidl-Cox on every 4th base-rate offset; top-K candidates with
        # one-preamble-symbol suppression
        sc_scan = 4 if (g.ngi % 4 == 0 and g.nfft % 8 == 0) else 1
        cand_step = ts_dec * sc_scan
        met, cfo_arr = sync.schmidl_cox_metric(bb_ts, g, decim=ts_dec,
                                               scan=sc_scan)
        n_k = 3
        sym_cand = max((g.nofdm * g.interp) // cand_step, 1)
        pos = torch.arange(met.shape[-1], device=dev)
        met_work = met
        cands, cfo_c, metrics = [], [], []
        for _ in range(n_k):
            idx_k = torch.argmax(met_work, dim=-1)
            cands.append(idx_k * cand_step)
            metrics.append(torch.gather(met, 1, idx_k[:, None])[:, 0])
            cfo_c.append(torch.gather(cfo_arr, 1, idx_k[:, None])[:, 0])
            suppress = torch.abs(pos[None] - idx_k[:, None]) < sym_cand
            met_work = torch.where(suppress, -1.0, met_work)

        # 2) delay and coarse CFO on the TS baseband decimated to mf_d interp
        # samples
        s_tmpl = self._mf_templates.shape[1]
        mf_d = 2 * ts_dec if s_tmpl % (2 * ts_dec) == 0 else ts_dec
        # sample a little early inside the guard interval, and keep the
        # frame inside the buffer
        max_delay = n - g.nofdm * (g.nsymb + g.preamble_nsymb) * g.interp
        rescue = None
        if self.deep_coherent:
            delay, coarse_cfo, delay2, cfo2, have2 = self._coherent_acquire(
                bb_ts, mf_d, ts_dec)
            rescue = (torch.clamp(delay2 - 8, 0, max_delay), cfo2, have2)
        else:
            delay, coarse_cfo = self._refine_arbitrate(bb_ts, cands, cfo_c,
                                                       mf_d, ts_dec)
        delay = torch.clamp(delay - 8, 0, max_delay)
        return delay, coarse_cfo, metrics[0], rescue

    def _refine_arbitrate(self, bb_ts: torch.Tensor, cands, cfo_c,
                          mf_d: int, ts_dec: int):
        """Matched-filter arbitration over (SC candidate x CFO alias) and, with
        deep sync, the noncoherent whole-buffer scan -> (delay [B], coarse
        CFO [B])."""
        g = self.geom
        b, n_ts = bb_ts.shape
        dev = bb_ts.device
        tmpl_d = self._mf_templates[:, ::mf_d]
        lp, s_d = tmpl_d.shape
        mf_s = mf_d // ts_dec
        window = 2 * g.nofdm * g.interp
        win_d = window // mf_d
        seg_d_len = 2 * win_d + lp * s_d
        max_start = (n_ts * ts_dec - seg_d_len * mf_d) // mf_d * mf_d
        alias = g.fs / ((g.nfft // 2) * g.interp)
        alias_offsets = (0.0, alias, -alias)
        tmpl_bank = self._rotated_bank(tmpl_d, alias_offsets, mf_d)
        lag = torch.arange(seg_d_len, device=dev)
        seg_rows, start_rows, cfo_rows = [], [], []
        for coarse, cfo_k in zip(cands, cfo_c):
            seg_start = torch.div(torch.clamp(coarse - window, 0,
                                              max(max_start, 0)),
                                  mf_d, rounding_mode="floor") * mf_d
            # clamp the slice start as lax.dynamic_slice does
            st_ts = torch.clamp(seg_start // ts_dec, 0,
                                n_ts - seg_d_len * mf_s)
            seg_d = torch.gather(bb_ts, 1, st_ts[:, None] + lag[None] * mf_s)
            t_seg = (seg_start[:, None].to(torch.float32)
                     + lag.to(torch.float32) * mf_d)
            rot = _cis((2 * np.pi / g.fs) * cfo_k[:, None] * t_seg)
            seg_rows.append(seg_d * rot)
            start_rows.append(seg_start // mf_d)
            cfo_rows.append(torch.stack([cfo_k + f_a for f_a in alias_offsets]))
        delay_f, score_f = sync.matched_filter_refine_bank(
            torch.cat(seg_rows), torch.cat(start_rows), tmpl_bank, win_d)
        n_c, n_a = len(cands), len(alias_offsets)
        # [K*B, A] -> [K*A, B]
        delays = (delay_f.reshape(n_c, b, n_a).transpose(1, 2)
                  .reshape(n_c * n_a, b) * mf_d)
        scores = score_f.reshape(n_c, b, n_a).transpose(1, 2).reshape(
            n_c * n_a, b)
        cfos = torch.cat(cfo_rows)
        if self.deep_sync:
            # whole-buffer known-preamble scan over a static CFO grid; its
            # hypotheses join the arbitration
            grid_f = np.arange(-4, 5) * DEEP_GRID_HZ          # +-120 Hz
            bank_g = self._rotated_bank(tmpl_d, grid_f, mf_d)
            win_g = (n_ts // mf_s - lp * s_d) // 2
            seg_g = bb_ts[:, : (2 * win_g + lp * s_d) * mf_s: mf_s]
            delay_g, score_g = sync.matched_filter_refine_bank(
                seg_g, torch.zeros(b, dtype=torch.int64, device=dev), bank_g,
                win_g)
            delays = torch.cat([delays, delay_g.T * mf_d])
            scores = torch.cat([scores, score_g.T])
            cfos = torch.cat([cfos, torch.as_tensor(
                grid_f, dtype=torch.float32, device=dev)[:, None].expand(-1, b)])
        pick = torch.argmax(scores, dim=0)[None]
        delay = torch.gather(delays, 0, pick)[0]
        coarse_cfo = torch.gather(cfos, 0, pick)[0]
        return delay, coarse_cfo

    def _decode_from(self, pb: torch.Tensor, delay: torch.Tensor,
                     coarse_cfo: torch.Tensor, metric: torch.Tensor):
        g = self.geom
        b = pb.shape[0]
        dec0 = self.extract_frame_decimated_pb(pb, delay, g.nsymb)
        t_dec = (delay[:, None].to(torch.float32)
                 + torch.arange(dec0.shape[-1], dtype=torch.float32,
                                device=pb.device) * g.interp)
        w = 2 * np.pi / g.fs

        def rotate(f: torch.Tensor) -> torch.Tensor:
            return dec0 * _cis(w * f[:, None] * t_dec)

        resid = sync.moose_cfo(rotate(coarse_cfo), g, self._pad_map)
        freq_m = coarse_cfo + resid
        freq_m = torch.where(torch.abs(freq_m) > 0.1, freq_m, 0.0)
        # CFO hypotheses (Moose is unambiguous within +-half a subcarrier);
        # the one with the lowest pilot variance wins. Per hypothesis only
        # the pilot cells are extracted (per-symbol partial DFT).
        subc = float(np.float32(g.bandwidth / g.nc))
        hyps = [freq_m, torch.zeros_like(freq_m), freq_m + subc, freq_m - subc]
        pre = g.preamble_nsymb * g.nofdm
        sel = []
        for f_h in hyps:
            sym = rotate(f_h)[:, pre:].reshape(b, g.nsymb, g.nofdm)
            sym = sym[..., g.ngi: g.ngi + g.nfft]
            y3 = torch.einsum("bst,spt->bsp", sym, self._pil_dft_op)
            y_pil = y3.reshape(b, -1)[:, self._pil_slot]
            y_pil = y_pil * (PILOT_BOOST / torch.mean(torch.abs(y_pil), dim=-1,
                                                      keepdim=True))
            h_pil = torch.complex(y_pil.real @ self._est_pil_op.T,
                                  y_pil.imag @ self._est_pil_op.T)
            h_eq = h_pil / torch.clamp(torch.abs(h_pil), min=1e-30)
            sel.append(torch.mean(torch.abs(y_pil / h_eq - self._pilot_seq)
                                  ** 2, dim=-1))
        pick = torch.argmin(torch.stack(sel), dim=0)[None]
        freq = torch.gather(torch.stack(hyps), 0, pick)[0]
        eq, variance, mean_h, var_full = self.grid_stats(
            self.demod_grid(rotate(freq)))
        data = eq[:, self._data_cells][:, self._tf_iperm]
        # the JAX receive applies no LLR calibration scale here
        llr = psk.demod(data, self._const, variance)[:, self._bit_iperm]
        payload, crc_ok, iters = self.llr_to_payload(llr)
        snr = 10.0 * torch.log10(1.0 / torch.clamp(var_full, min=1e-30))
        return RxResult(payload, crc_ok, delay, freq, snr, iters, metric,
                        mean_h)

    @torch.no_grad()
    def receive(self, pb_buffer) -> RxResult:
        """Full RX: sync + CFO + decode. pb_buffer: [B, buffer_samples]
        (any real dtype; moved to the chain's device as float32).

        On the coherent deep-acquisition path (CONFIG_0), when a row fails
        its CRC the whole batch is decoded once more at the runner-up
        candidate, and a row takes that result where it passes and its own
        did not. Deciding whether to run that decode reads crc_ok on the host
        (one device sync per call on that path)."""
        pb = torch.as_tensor(pb_buffer).to(device=self.device,
                                           dtype=torch.float32).contiguous()
        with _full_fp32_matmul():
            delay, coarse_cfo, metric, rescue = self._acquire(pb)
            out = self._decode_from(pb, delay, coarse_cfo, metric)
            if rescue is None or bool(out.crc_ok.all()):
                return out
            delay2, cfo2, have2 = rescue
            out2 = self._decode_from(pb, delay2, cfo2, metric)
        use2 = ~out.crc_ok & out2.crc_ok & have2
        merged = {}
        for f in dataclasses.fields(RxResult):
            a1, a2 = getattr(out, f.name), getattr(out2, f.name)
            merged[f.name] = torch.where(
                use2.reshape((-1,) + (1,) * (a1.ndim - 1)), a2, a1)
        return RxResult(**merged)
