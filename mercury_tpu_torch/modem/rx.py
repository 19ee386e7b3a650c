"""Receive chain: passband capture buffer -> decoded payload (PyTorch port of
`RxChain` in the JAX package's `modem/rx.py`: the OFDM modes CONFIG_0-16 and
the MFSK ROBUST modes CONFIG_100-102 at both pilot densities, with the MFSK
short control frames of ROBUST_0/1).

Stages, in order: mixer + strided time-sync FIR (CUDA kernel
`mix_fir_decimate`), Schmidl-Cox top-K candidates, then the delay and coarse
CFO: matched-filter refinement over (candidate x CFO alias) and, on the
deep-sync modes, a noncoherent whole-buffer known-preamble scan (both CUDA
kernel `deep_mf_score`); or, on CONFIG_0, the coherent whole-buffer scan
(`deep_mf_max`) whose top candidates the pilot lattice arbitrates
(`pilot_cand_score`). Then frame extraction through the data FIR
(`mix_fir_decimate` with per-row starts), Moose CFO and the pilot-variance
pick among CFO hypotheses, FFT demod, ramp-aware LS channel estimate, max-log
demap, LDPC and the CRC16 check; on CONFIG_0 a batch with a failed row is
decoded once more at the runner-up candidate. The zero-forcing estimator
(estimator="reference" on CONFIG_15/16) picks its CFO hypothesis by the
hard-decision error of a full grid each. Rows whose first LDPC decode fails
can be re-decoded by BICM-ID (decoder extrinsics as priors of a log-MAP
demapper; auto on 32QAM) and by decision-directed re-estimation (the decoded
codeword as pilots on every cell; auto on 8PSK/16QAM/32QAM with the LS
estimator). QAM modes report the SNR from the re-encoded decisions (MER).

An MFSK mode takes the same time-sync FIR, then scores the preamble tones
at every symbol-aligned start (`sync.mfsk_sync_metric`), decodes at the
best (data FIR, FFT, energy-detection soft demod, LDPC, CRC16) and decodes
the rows that fail once more at the runner-up start.

decode_at decodes each row at a known delay and frequency offset: the data
FIR kernel mixes the frame's segment at fc + f[b] (the oscillator table
turned by the row's rotation). refine_decode first re-syncs each row with
the known-preamble matched filter over its full-rate segment
(`deep_mf_score`), as the link does for the sibling frames of a batch.

JAX's jit/vmap/lax control flow becomes eager code over a written-out batch
axis. Float32 matmuls run at full precision (no TF32) inside `receive`.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from mercury_tpu_torch import obs
from mercury_tpu_torch.convert import resolve_device
from mercury_tpu_torch.core import crc as crc_mod
from mercury_tpu_torch.core import hostdsp
from mercury_tpu_torch.core.geometry import LS_WINDOW, ModeGeometry
from mercury_tpu_torch.core.modes import ZERO_FORCE
from mercury_tpu_torch.dsp import kernels, ops
from mercury_tpu_torch.fec import ldpc
from mercury_tpu_torch.fec.tables import load_code
from mercury_tpu_torch.modem import mfsk, psk, sync

PILOT_BOOST = 1.33
DEEP_GRID_HZ = 30.0      # whole-buffer scan CFO grid ("pruned", "c2f")
DEEP_FULL_GRID_HZ = 15.0  # whole-buffer scan CFO grid ("full" profile)
C2F_TOPN = 4             # c2f: scan rows that join the refinement
DEEP_COH_GRID_HZ = 4.0   # coherent whole-buffer scan CFO grid (CONFIG_0)
DEEP_PIL_TOPM = 32       # coherent-scan nominees the pilot lattice re-scores
LDPC_ALGOS = ("spa", "minsum", "layered", "layered-minsum")
STAGES = ("sync", "arb", "refine", "hyp", "full")


@dataclass
class RxResult:
    """Per-frame decode outcome (all tensors batched)."""
    payload: torch.Tensor       # [B, frame_bytes] uint8
    crc_ok: torch.Tensor        # [B] bool (CRC passed, not all-zeros)
    delay: torch.Tensor         # [B] int32 frame start (interp samples)
    freq_offset: torch.Tensor   # [B] float32 Hz
    snr_db: torch.Tensor        # [B] float32
    iters: torch.Tensor         # [B] int32 LDPC sweeps
    sync_metric: torch.Tensor   # [B] float32 coarse sync correlation
    mean_h: torch.Tensor        # [B] float32 mean |H| at the pilots (MFSK: 1)


def host_constants(geom: ModeGeometry, deep_sync: bool, dd: bool = False,
                   dd_window: tuple[int, int] = (LS_WINDOW, LS_WINDOW)
                   ) -> tuple[dict[str, np.ndarray], dict]:
    """The receive constants of a mode, built on the host exactly as the JAX
    RxChain builds them: (arrays by buffer name, scalars of the channel
    estimator). An MFSK mode has the FIRs, the index maps, the preamble's
    matched-filter templates and the CRC map only. Of an OFDM mode, the LS
    estimator has the timing-ramp pairs, the zero-forcing one its
    leave-one-out pilot smoother; the pilot-only symbol waveforms exist
    with deep sync only and the decision-directed constants with dd only,
    as in the JAX chain."""
    g = geom
    arrays = {
        "_fir_ts": g.fir_rx_ts, "_fir_data": g.fir_rx_data,
        "_pad_map": g.pad_map, "_bit_iperm": g.bit_iperm,
        "_tf_iperm": g.tf_iperm, "_data_cells": g.data_cells,
        "_pilot_cells": np.asarray(g.pilot_cells),
        "_dispersal": g.dispersal[: g.n_real],
    }
    scalars = {}
    if g.spec.is_mfsk:
        pre_vals = mfsk.preamble_grid(g.mfsk, g.nc, g.preamble_nsymb)
    else:
        arrays.update({
            "_bit_perm": g.bit_perm, "_tf_perm": g.tf_perm,
            "_pilot_seq": np.asarray(g.pilot_seq, np.complex64),
            "_est_op": g.est_op,
            "_const": np.asarray(g.constellation, np.complex64)})
        if g.estimator == ZERO_FORCE:
            arrays["_loo_op"], loo_scale = _loo_operator(g)
            scalars = {"loo_scale": loo_scale}
        else:
            scalars = _ramp_pairs(g, arrays)
        if dd:
            arrays.update(_dd_constants(g, dd_window))
        _sync_constants(g, deep_sync, arrays)
        pre_vals = g.preamble_vals
        if g.pre_eq is not None:
            pre_vals = pre_vals * g.pre_eq[None, :]
    # known-preamble matched-filter templates (interp-rate waveforms)
    td = np.concatenate([hostdsp.symbol_mod(pre_vals[l], g.nfft, g.ngi, 1)
                         for l in range(g.preamble_nsymb)])
    tmpl = hostdsp.linear_interp_x4(td, g.interp)
    arrays["_mf_templates"] = np.asarray(
        tmpl.reshape(g.preamble_nsymb, g.nofdm * g.interp), np.complex64)
    a, c0 = crc_mod.crc_affine(g.frame_bytes + 2)
    arrays["_crc_a"] = a.astype(np.float32)
    arrays["_crc_c0"] = c0
    return arrays, scalars


def rx_buffers(arrays: dict[str, np.ndarray], device=None,
               real_dtype: torch.dtype = torch.float32
               ) -> dict[str, torch.Tensor]:
    """Receive constants (host_constants' arrays, or the same names taken
    from a JAX chain) -> the chain's buffers on `device` (the card unless
    given; see resolve_device): complex arrays of the chain's complex type,
    floating ones of its real type, except the CRC map `_crc_a`, which
    stays float32, and every other array int64. Floating values pass
    through float32 (complex64) first, so a float64 chain holds the same
    constants as a float32 one."""
    device = resolve_device(device)
    cdtype = (torch.complex128 if real_dtype == torch.float64
              else torch.complex64)
    out = {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if np.iscomplexobj(arr):
            host, dtype = np.complex64, cdtype
        elif np.issubdtype(arr.dtype, np.floating):
            host = np.float32
            dtype = torch.float32 if name == "_crc_a" else real_dtype
        else:
            host, dtype = np.int64, torch.int64
        out[name] = torch.from_numpy(arr.astype(host)).to(device, dtype)
    return out


def _loo_operator(g: ModeGeometry) -> tuple[np.ndarray, float]:
    """The zero-forcing noise estimate's leave-one-out pilot smoother: each
    pilot's channel predicted as the mean of its k = 4 nearest pilots on
    the (symbol, carrier) lattice (the ZF estimate passes exactly through
    the pilots, so only this residual measures noise), and the k/(k+1)
    correction for the prediction's own noise."""
    k_nn = 4
    s_pil = (g.pilot_cells // g.nc).astype(np.float64)
    c_pil = (g.pilot_cells % g.nc).astype(np.float64)
    npil = len(g.pilot_cells)
    d2 = ((s_pil[:, None] - s_pil[None, :]) ** 2
          + (c_pil[:, None] - c_pil[None, :]) ** 2)
    np.fill_diagonal(d2, np.inf)
    s_loo = np.zeros((npil, npil), np.float64)
    for i in range(npil):
        s_loo[i, np.argsort(d2[i])[:k_nn]] = 1.0 / k_nn
    return s_loo.astype(np.float32), k_nn / (k_nn + 1.0)


def _dd_constants(g: ModeGeometry, dd_window: tuple[int, int]
                  ) -> dict[str, np.ndarray]:
    """Decision-directed constants: the gather map placing the known pilots
    and the re-encoded symbol decisions (tf-deinterleaved order) on the flat
    grid (unused cells -> a trailing zero slot), and the 0/1 box-window
    matrices of the separable (symbol x carrier) smoothing."""
    npil, ndata = len(g.pilot_cells), len(g.data_cells)
    src = np.full(g.nsymb * g.nc, npil + ndata, np.int64)
    src[np.asarray(g.pilot_cells)] = np.arange(npil)
    src[np.asarray(g.data_cells)[np.asarray(g.tf_iperm)]] = (
        npil + np.arange(ndata))
    half_s, half_c = dd_window[0] // 2, dd_window[1] // 2
    idx_s, idx_c = np.arange(g.nsymb), np.arange(g.nc)
    return {"_dd_src": src,
            "_dd_box_s": (np.abs(idx_s[:, None] - idx_s[None, :]) <= half_s
                          ).astype(np.float32),
            "_dd_box_c": (np.abs(idx_c[:, None] - idx_c[None, :]) <= half_c
                          ).astype(np.float32)}


def _ramp_pairs(g: ModeGeometry, arrays: dict) -> dict:
    """The ramp-aware LS estimator's pilot pairs (into arrays) and scalars:
    same-symbol carrier-adjacent pilot pairs give the timing-ramp slope;
    signed FFT bins keep the ramp continuous mid-band."""
    pilot_cells = np.asarray(g.pilot_cells)
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
    return scalars


def _sync_constants(g: ModeGeometry, deep_sync: bool, arrays: dict) -> None:
    """The CFO-hypothesis and pilot-lattice constants (into arrays)."""
    pilot_cells = np.asarray(g.pilot_cells)
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


def _cis(theta: torch.Tensor) -> torch.Tensor:
    """e^{j theta} for a real tensor."""
    return torch.complex(torch.cos(theta), torch.sin(theta))


class RxChain(nn.Module):
    """Per-mode RX program for every mode (CONFIG_0-16, 100-102).

    Options as in the JAX RxChain. cfo_range "wide" (default) arbitrates
    the 93.75 Hz coarse-CFO alias by a 3-way matched-filter vote and 4 CFO
    hypotheses; "narrow" (~+-45 Hz) takes 2 Schmidl-Cox candidates, no
    alias, 2 CFO hypotheses and narrower deep-scan grids. deep_sync (auto:
    CONFIG_0-4) adds the whole-buffer known-preamble scan: noncoherent, or with
    deep_coherent (auto: CONFIG_0) the coherent scan, pilot-lattice
    arbitration and the CRC-gated rescue decode.

    ldpc_algo: "layered" (SPA) or "layered-minsum" (the layered schedule),
    "spa" or "minsum" (flooding). llr_scale: the demapper's LLR calibration
    (None: 0.85 at rate 1/16, else 0.9). dd: decision-directed
    re-estimation of the rows whose first decode failed (None: on for 8+
    point constellations with the LS estimator), smoothing over dd_window
    (symbols, carriers; odd, default the LS window), dd_passes times.
    bicm_iters: BICM-ID passes on failed rows (None: 2 for 32QAM with a
    layered decoder, else 0).

    MFSK modes: ctrl decodes the short control frames of ROBUST_0/1 (only
    ctrl_nsymb symbols; the punctured LLRs are erasures). mfsk_soft
    ("sumexp" or "maxlog"), mfsk_noise_pool, mfsk_exp_scale and mfsk_clamp
    are mfsk.demod's options; with mfsk_sync_cands > 1 a row whose decode
    fails is decoded once more at the runner-up sync candidate. Deep sync,
    DD and BICM-ID do not apply (dd or bicm_iters raise ValueError).

    deep_profile (deep sync without deep_coherent): "pruned" scans the
    whole buffer on a 30 Hz CFO grid whose rows join the arbitration,
    "full" on a 15 Hz grid; "c2f" takes the 30 Hz scan's best 4 (delay,
    CFO) rows into the matched-filter refinement beside the Schmidl-Cox
    candidates, whose bank gains +-15 Hz offsets (c2f replaces the coherent
    scan, as in the JAX chain). real_dtype torch.float64 runs the front
    end, sync and estimation in float64 (the LDPC stays float32, as the JAX
    decoder); the kernels are float32, so it needs device="cpu"
    (ValueError on a card).
    `recovery` counts the rows re-decoded by BICM-ID, by DD
    and at the MFSK runner-up candidate, summed over passes and calls
    (reset_recovery sets them to 0).

    The chain lives on the CUDA card unless `device` names another;
    device="cpu" runs the kernels' plain versions (see
    convert.resolve_device).
    """

    def __init__(self, geom: ModeGeometry, device=None,
                 real_dtype: torch.dtype = torch.float32, ctrl: bool = False,
                 cfo_range: str = "wide", deep_sync: bool | None = None,
                 ldpc_algo: str = "layered", deep_profile: str = "pruned",
                 deep_coherent: bool | None = None,
                 dd: bool | None = None, bicm_iters: int | None = None,
                 dd_window: tuple[int, int] | None = None,
                 dd_passes: int = 1, ldpc_max_iter: int = 50,
                 llr_scale: float | None = None, mfsk_soft: str = "sumexp",
                 mfsk_noise_pool: bool = True, mfsk_sync_cands: int = 2,
                 mfsk_exp_scale: float = 1.0, mfsk_clamp: float = 5.0):
        # the constructor's options as given, for replica()
        options = {k: v for k, v in locals().items()
                   if k not in ("self", "geom", "device", "__class__")}
        super().__init__()
        g = geom
        device = resolve_device(device)
        if real_dtype not in (torch.float32, torch.float64):
            raise ValueError("real_dtype must be torch.float32 or "
                             "torch.float64")
        if real_dtype == torch.float64 and device.type != "cpu":
            raise ValueError("real_dtype=torch.float64 runs the plain "
                             "versions only (the CUDA kernels are float32): "
                             "pass device='cpu'")
        is_mfsk = g.spec.is_mfsk
        if ctrl and not (is_mfsk and g.spec.ctrl_nbits > 0):
            raise ValueError("ctrl frames exist only for ROBUST_0/ROBUST_1")
        if cfo_range not in ("wide", "narrow"):
            raise ValueError("cfo_range must be 'wide' or 'narrow'")
        if deep_profile not in ("pruned", "c2f", "full"):
            raise ValueError("deep_profile must be 'pruned', 'c2f' or 'full'")
        if mfsk_soft not in ("sumexp", "maxlog"):
            raise ValueError("mfsk_soft must be 'sumexp' or 'maxlog'")
        if deep_sync is None:
            deep_sync = not is_mfsk and g.spec.config <= 4
        if deep_coherent is None:
            deep_coherent = not is_mfsk and g.spec.config == 0
        if ldpc_algo not in LDPC_ALGOS:
            raise ValueError("ldpc_algo must be 'spa', 'minsum', 'layered' "
                             "or 'layered-minsum'")
        if llr_scale is None:
            llr_scale = 0.85 if g.spec.ldpc_rate_num == 1 else 0.9
        # a float32 tensor times a Python float rounds it to float32, as the
        # JAX chain's np.float32(llr_scale)
        self.llr_scale = float(llr_scale)
        zf = g.estimator == ZERO_FORCE
        n_const = 0 if is_mfsk else len(g.constellation)
        if dd is None:
            dd = not zf and n_const >= 8
        if dd and (is_mfsk or zf):
            raise ValueError("decision-directed estimation requires an OFDM "
                             "mode with the LS estimator")
        layered = ldpc_algo in ("layered", "layered-minsum")
        if bicm_iters is None:
            bicm_iters = 2 if n_const == 32 and layered else 0
        if bicm_iters and is_mfsk:
            raise ValueError("bicm_iters requires an OFDM mode")
        if bicm_iters and not layered:
            raise ValueError("bicm_iters requires the layered decoder "
                             "(soft posterior output)")
        if dd_window is None:
            dd_window = (LS_WINDOW, LS_WINDOW)
        if dd_window[0] % 2 == 0 or dd_window[1] % 2 == 0:
            raise ValueError("dd_window spans must be odd")
        self._options = options
        self.geom = g
        self.real_dtype = real_dtype
        self.cdtype = (torch.complex128 if real_dtype == torch.float64
                       else torch.complex64)
        self.zf = zf
        self.cfo_range = cfo_range
        self.deep_sync = bool(deep_sync)
        self.deep_profile = deep_profile
        self.deep_coherent = (self.deep_sync and bool(deep_coherent)
                              and deep_profile != "c2f")
        self.ldpc_algo = ldpc_algo
        self.dd = bool(dd)
        self.dd_window = (int(dd_window[0]), int(dd_window[1]))
        self.dd_passes = int(dd_passes)
        self.bicm_iters = int(bicm_iters)
        self.ldpc_max_iter = int(ldpc_max_iter)
        self.ctrl = bool(ctrl)
        self.active_nsymb = g.ctrl_nsymb if ctrl else g.nsymb
        self.active_nbits = g.spec.ctrl_nbits if ctrl else g.n_bits
        self.mfsk_soft = mfsk_soft
        self.mfsk_noise_pool = bool(mfsk_noise_pool)
        self.mfsk_sync_cands = int(mfsk_sync_cands)
        self.mfsk_exp_scale = float(mfsk_exp_scale)
        self.mfsk_clamp = float(mfsk_clamp)
        arrays, scalars = host_constants(g, self.deep_sync, self.dd,
                                         self.dd_window)
        for name, t in rx_buffers(arrays, device, real_dtype).items():
            self.register_buffer(name, t)
        for name, value in scalars.items():     # the estimator's scalars
            setattr(self, name, value)
        self.crc_nbits = (g.frame_bytes + 2) * 8
        # the LDPC generator re-encodes decisions (DD, MER SNR); it is the
        # code table's, not a receive constant of the JAX chain
        code = load_code(g.spec.ldpc_rate_num)
        self.code_k = code.k
        self.register_buffer("_gen", torch.as_tensor(
            code.gen.astype(np.float32)), persistent=False)
        check = "minsum" if ldpc_algo.endswith("minsum") else "spa"
        if layered:
            self.decoder = ldpc.LayeredDecoder(g.spec.ldpc_rate_num,
                                               ldpc_max_iter, algo=check)
        else:
            self.decoder = ldpc.FloodingDecoder(g.spec.ldpc_rate_num,
                                                ldpc_max_iter, algo=check)
        self._osc_cache: dict = {}
        self._bank_cache: dict = {}
        self.reset_recovery()
        self.to(device)

    def replica(self, device) -> "RxChain":
        """A chain built on `device` with this chain's options, buffers and
        LDPC cap and LLR scale; its caches and recovery counts are its own
        (a scale.shard shard's chain)."""
        twin = RxChain(self.geom, device=device, **self._options)
        twin.load_state_dict(self.state_dict())
        twin.set_ldpc_max_iter(self.ldpc_max_iter)
        twin.llr_scale = self.llr_scale
        return twin

    def reset_recovery(self) -> None:
        self.recovery = {"bicm_rows": 0, "dd_rows": 0, "mfsk_rows": 0}

    def set_ldpc_max_iter(self, n: int) -> None:
        """Change the LDPC iteration cap (the reference's -I flag and GUI
        slider); the next decode uses it."""
        self.ldpc_max_iter = int(n)
        self.decoder.max_iter = int(n)

    @property
    def device(self) -> torch.device:
        return self._fir_ts.device

    # ------------------------------------------------------------------
    def _osc_const(self, n: int) -> torch.Tensor:
        """sqrt(2)*exp(+j*2*pi*fc/fs*i) for i < n: float64 phase on the
        host, complex64 on the device, built once per length."""
        return ops.cached(
            self._osc_cache, (n, self.device), lambda: ops.mixer_table(
                n, self.geom.fc, self.geom.fs, self.device, self.cdtype))

    def mix(self, pb: torch.Tensor, freq_offset=0.0) -> torch.Tensor:
        """Passband [B, n] -> complex IQ at fc + freq_offset ([B] or
        scalar), unfiltered."""
        g = self.geom
        n = pb.shape[-1]
        pb = pb.to(self.real_dtype)
        if isinstance(freq_offset, (int, float)) and freq_offset == 0.0:
            return pb * self._osc_const(n)
        t = torch.arange(n, dtype=self.real_dtype, device=pb.device)
        f = torch.as_tensor(freq_offset, dtype=self.real_dtype,
                            device=pb.device)
        f = f.reshape(-1, 1) if f.ndim else f
        ph = (2 * math.pi / g.fs) * (g.fc + f) * t
        return pb * math.sqrt(2.0) * _cis(ph)

    def _row_freq(self, freq_offset, b: int) -> torch.Tensor | None:
        """A frequency offset ([B] or scalar, Hz) as float32 [B] on the
        chain's device, or None for None or a Python 0 (the oscillator table
        alone, the kernel's form without offsets)."""
        if freq_offset is None or (isinstance(freq_offset, (int, float))
                                   and freq_offset == 0.0):
            return None
        f = torch.as_tensor(freq_offset, dtype=self.real_dtype,
                            device=self.device)
        return f.expand(b).contiguous() if f.ndim == 0 else f.contiguous()

    def to_baseband(self, pb, freq_offset=0.0,
                    data_fir: bool = True) -> torch.Tensor:
        """Passband [B, n] -> interp-rate complex baseband [B, n], mixed at
        fc + freq_offset ([B] or scalar, Hz; float64 phase) and filtered by
        the data FIR (or the TS FIR): fir_same(mix(pb, f)), the kernel's
        stride-1 "same" form."""
        pb = self._as_buffer(pb)
        b, n = pb.shape
        taps = self._fir_data if data_fir else self._fir_ts
        return kernels.mix_fir_decimate(
            pb, self._osc_const(n), taps, 1,
            freq=self._row_freq(freq_offset, b), fs=self.geom.fs)

    @torch.no_grad()
    def measure_signal_dbm(self, pb) -> torch.Tensor:
        """Idle-channel signal strength in dBm re 1 mW, [B, n] -> [B]
        (reference measure_signal_only): the mean complex power of the TS-FIR
        baseband at the full rate, 10*log10(P / 1 mW)."""
        bb = self.to_baseband(pb, data_fir=False)
        p = torch.mean(bb.real ** 2 + bb.imag ** 2, dim=-1)
        return 10.0 * torch.log10(torch.clamp(p, min=1e-30) / 1e-3)

    def extract_frame(self, bb: torch.Tensor,
                      delay: torch.Tensor) -> torch.Tensor:
        """The frame of interp-rate baseband bb [B, n] at per-row delay,
        decimated to the base rate [B, (active_nsymb + P)*Nofdm]; the start
        clamped into the row as lax.dynamic_slice clamps it."""
        g = self.geom
        frame_len = g.nofdm * (self.active_nsymb + g.preamble_nsymb) * g.interp
        start = torch.clamp(torch.as_tensor(delay, device=bb.device).long(),
                            0, bb.shape[-1] - frame_len)
        idx = start[:, None] + torch.arange(0, frame_len, g.interp,
                                            device=bb.device)
        return torch.gather(bb, 1, idx)

    def _frame_segment(self, n: int, delay: torch.Tensor, n_symb: int):
        """(start [B], segment length, output length) of the data FIR over
        the frame of n_symb symbols at delay: the start clipped as the JAX
        chain clips its padded slice."""
        g = self.geom
        ntaps = self._fir_data.shape[0]
        center = (ntaps - 1) // 2
        frame_interp = g.nofdm * (n_symb + g.preamble_nsymb) * g.interp
        seg_len = frame_interp + ntaps - 1
        start = torch.clamp(delay.long(), 0, n + center + ntaps - seg_len)
        return start.contiguous(), seg_len, frame_interp // g.interp

    def extract_frame_decimated(self, iq: torch.Tensor, delay: torch.Tensor,
                                n_symb: int) -> torch.Tensor:
        """Complex IQ [B, n] (already mixed) -> the decimated frame
        [B, (n_symb + P)*Nofdm] at per-row delay: the data FIR over the
        frame's segment only, equal to fir_same(iq)[delay::interp]. For a
        caller that holds IQ; the decode paths mix and filter in the kernel
        (extract_frame_decimated_pb)."""
        ntaps = self._fir_data.shape[0]
        center = (ntaps - 1) // 2
        start, seg_len, _ = self._frame_segment(iq.shape[-1], delay, n_symb)
        iq_pad = torch.nn.functional.pad(iq, (center, ntaps))
        idx = start[:, None] + torch.arange(seg_len, device=iq.device)
        return ops.fir_decimate_segment(torch.gather(iq_pad, 1, idx),
                                        self._fir_data, self.geom.interp)

    def extract_frame_decimated_pb(self, pb: torch.Tensor, delay: torch.Tensor,
                                   n_symb: int,
                                   freq: torch.Tensor | None = None
                                   ) -> torch.Tensor:
        """Mixer + data FIR over the frame only: the decimated baseband
        [B, (n_symb + preamble)*Nofdm] of the frame starting at per-row
        `delay` (interp samples), equal to fir_same(mix(pb, freq))
        [delay::interp] (freq [B] Hz, or None for fc alone). The start is
        clipped as the JAX chain clips its padded slice."""
        g = self.geom
        ntaps = self._fir_data.shape[0]
        start, _, n_out = self._frame_segment(pb.shape[-1], delay, n_symb)
        return kernels.mix_fir_decimate(
            pb, self._osc_const(pb.shape[-1]), self._fir_data, g.interp,
            start=start, n_out=n_out, offset=ntaps - 1 - (ntaps - 1) // 2,
            freq=freq, fs=g.fs)

    def mix_segment(self, pb: torch.Tensor, start: torch.Tensor,
                    length: int,
                    freq: torch.Tensor | None = None) -> torch.Tensor:
        """mix(pb, freq)[b, start[b] : start[b] + length] without mixing the
        rest of the row: the float64-phase oscillator turned by each row's
        offset (kernels.row_rotation; freq None for fc alone), as the FIR
        kernel mixes."""
        idx = start.long()[:, None] + torch.arange(length, device=pb.device)
        osc = self._osc_const(pb.shape[-1])[idx]
        if freq is not None:
            osc = osc * kernels.row_rotation(freq, self.geom.fs, idx)
        return torch.gather(pb, 1, idx) * osc

    def demod_grid(self, frame_decim: torch.Tensor) -> torch.Tensor:
        """Decimated frame [B, (P+S)*Nofdm] -> carrier grid [B, S, Nc]
        (S = active_nsymb: Nsymb, or ctrl_nsymb for a control frame)."""
        g = self.geom
        b = frame_decim.shape[0]
        sym = frame_decim[:, g.preamble_nsymb * g.nofdm:].reshape(
            b, self.active_nsymb, g.nofdm)
        return ops.ofdm_demod(sym, self._pad_map, g.nfft, g.ngi)

    def grid_stats(self, grid: torch.Tensor):
        """AGC + channel estimate + equalization of a carrier grid
        [B, S, Nc] -> (equalized flat grid, variance, mean_h, var_full)."""
        return self._grid_stats_internal(grid)[:4]

    def _grid_stats_internal(self, grid: torch.Tensor):
        """grid_stats plus what the decision-directed pass needs: the AGC'd
        flat grid and the timing-ramp slope (zeros for zero-forcing, which
        has no ramp model). PSK modes equalize by the channel's phase
        (amplitude restoration), QAM modes by the channel itself. The noise
        variance is the equalized pilots' residual (LS), or the pilots'
        leave-one-out residual (ZF, whose estimate passes through them)."""
        b = grid.shape[0]
        flat = grid.reshape(b, -1)
        y_pil = flat[:, self._pilot_cells]
        gain = PILOT_BOOST / torch.mean(torch.abs(y_pil), dim=-1, keepdim=True)
        flat = flat * gain
        y_pil = y_pil * gain
        if self.zf:
            h = torch.complex(y_pil.real @ self._est_op.T,
                              y_pil.imag @ self._est_op.T)
            slope = torch.zeros(b, device=grid.device)
        else:
            slope = self._ramp_slope(y_pil / self._pilot_seq)
            y_est = y_pil * _cis(-slope[:, None] * self._pil_bins[None])
            h = torch.complex(y_est.real @ self._est_op.T,
                              y_est.imag @ self._est_op.T)
            h = h * _cis(slope[:, None] * self._cell_bins[None])
        h_pil = h[:, self._pilot_cells]
        mean_h = torch.mean(torch.abs(h_pil), dim=-1)
        eq = flat / self._h_eq(h)
        if self.zf:
            h_meas = y_pil / self._pilot_seq
            h_loo = torch.complex(h_meas.real @ self._loo_op.T,
                                  h_meas.imag @ self._loo_op.T)
            resid = (h_meas - h_loo) * self._pilot_seq
            variance = (torch.mean(torch.abs(resid) ** 2, dim=-1)
                        * self.loo_scale)
        else:
            variance = torch.mean(torch.abs(eq[:, self._pilot_cells]
                                            - self._pilot_seq) ** 2, dim=-1)
        var_full = torch.mean(torch.abs(y_pil / h_pil - self._pilot_seq) ** 2,
                              dim=-1)
        return eq, variance, mean_h, var_full, flat, slope

    def _ramp_slope(self, h_meas: torch.Tensor) -> torch.Tensor:
        """The timing-ramp slope [B] from the pilot pairs' correlation
        angle, shrunk by its coherence (near 1 on clean signals, near 0
        where the angle is noise) and refined by the long-lag pairs."""
        pa = h_meas[:, self._ramp_a]
        pb = h_meas[:, self._ramp_b]
        corr = torch.sum(pa * torch.conj(pb), dim=-1)
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
        return torch.clamp(slope, -self.ramp_max, self.ramp_max)

    def _h_eq(self, h: torch.Tensor) -> torch.Tensor:
        """What a cell is divided by: the channel's phase on PSK modes
        (amplitude restoration), the channel itself on QAM modes."""
        if self.geom.spec.amplitude_restoration:
            return h / torch.clamp(torch.abs(h), min=1e-30)
        return h

    # ------------------------------------------------------------------
    def _demap(self, eq: torch.Tensor, variance: torch.Tensor,
               scale: float | None):
        """Equalized flat grid -> (LLRs in wire order [B, nBits], data
        symbols in tf-deinterleaved order), the LLRs times scale if given."""
        data = eq[:, self._data_cells][:, self._tf_iperm]
        llr = psk.demod(data, self._const, variance)
        if scale is not None:
            llr = llr * scale
        return llr[:, self._bit_iperm], data

    def _ofdm_llr(self, grid: torch.Tensor):
        """Carrier grid -> calibrated deinterleaved LLRs, and (flat AGC'd
        grid, ramp slope, equalized data, variance, mean_h, var_full)."""
        eq, variance, mean_h, var_full, flat, slope = \
            self._grid_stats_internal(grid)
        llr, data = self._demap(eq, variance, self.llr_scale)
        return llr, (flat, slope, data, variance, mean_h, var_full)

    def decode_ofdm(self, grid: torch.Tensor):
        """Carrier grid -> (LLRs, SNR dB, mean_h, equalized data)."""
        llr, (_f, _s, data, variance, mean_h, var_full) = self._ofdm_llr(grid)
        var = var_full if self.geom.spec.amplitude_restoration else variance
        snr = 10.0 * torch.log10(1.0 / torch.clamp(var, min=1e-30))
        return llr, snr, mean_h, data

    # ------------------------------------------------------------------
    def _reencode_symbols(self, wire_bits: torch.Tensor) -> torch.Tensor:
        """Decoded wire bits [B, nReal] (after dispersal, as sent) ->
        re-encoded, re-modulated data symbols in tf-deinterleaved order: the
        decision feedback of the MER SNR and of the DD re-estimate."""
        g = self.geom
        u = torch.cat([wire_bits, wire_bits[:, : g.n_virtual]], dim=-1)
        cw = ldpc.encode(self._gen, u)
        tx_bits = torch.cat([wire_bits, cw[:, self.code_k:]], dim=-1)
        return psk.mod(tx_bits[:, self._bit_perm], self._const)

    def _mer_snr(self, real_bits: torch.Tensor,
                 data_eq: torch.Tensor) -> torch.Tensor:
        """SNR dB from the modulation error: the re-encoded decisions
        against the equalized data symbols (reference
        telecom_system.cc:1376-1401)."""
        ideal = self._reencode_symbols(real_bits ^ self._dispersal[None])
        var = torch.mean(torch.abs(ideal - data_eq) ** 2, dim=-1)
        return -10.0 * torch.log10(torch.clamp(var, min=1e-30))

    def _dd_demod(self, flat: torch.Tensor, slope: torch.Tensor,
                  wire_bits: torch.Tensor):
        """Decision-directed demod: the re-encoded codeword and the pilots
        as known symbols x on every cell, H = box(y x*) / box(|x|^2) over a
        (symbol x carrier) box window (two small matmuls), the timing ramp
        of the first pass taken out before the average and put back after;
        then re-equalize and re-demap. -> (LLRs, data, variance, mean_h,
        var_full)."""
        g = self.geom
        b = flat.shape[0]
        ideal = self._reencode_symbols(wire_bits)
        npil = self._pilot_seq.shape[0]
        xsrc = torch.cat([self._pilot_seq[None].expand(b, npil), ideal,
                          torch.zeros_like(ideal[:, :1])], dim=-1)
        x_flat = xsrc[:, self._dd_src]                         # [B, S*Nc]
        rot = _cis(-slope[:, None] * self._cell_bins[None])
        num = flat * rot * torch.conj(x_flat)
        den = torch.abs(x_flat) ** 2
        sh = (b, g.nsymb, g.nc)

        def box2d(x):                                          # [B, S, Nc]
            return (self._dd_box_s @ x.reshape(sh) @ self._dd_box_c
                    ).reshape(b, -1)

        h = (torch.complex(box2d(num.real), box2d(num.imag))
             / torch.clamp(box2d(den), min=1e-12))
        h = h * torch.conj(rot)
        h_pil = h[:, self._pilot_cells]
        mean_h = torch.mean(torch.abs(h_pil), dim=-1)
        eq = flat / self._h_eq(h)
        variance = torch.mean(torch.abs(eq[:, self._pilot_cells]
                                        - self._pilot_seq) ** 2, dim=-1)
        var_full = torch.mean(torch.abs(flat[:, self._pilot_cells] / h_pil
                                        - self._pilot_seq) ** 2, dim=-1)
        llr, data = self._demap(eq, variance, self.llr_scale)
        return llr, data, variance, mean_h, var_full

    def _decode_llr_dd(self, llr, flat, slope, data, variance, var_full,
                       mean_h):
        """LDPC decode (with BICM-ID when on), then, with dd, the
        decision-directed pass dd_passes times on the rows that have not
        converged: each pass re-estimates from the last decisions and a row
        takes its new result. Converged rows keep theirs. Which rows are
        left is read on the host (one sync per pass; none runs when every
        row converged). -> (payload, crc_ok, iters, real_bits, data,
        variance, var_full, mean_h)."""
        payload, crc_ok, iters, real_bits, conv = self.llr_to_payload(
            llr, data, variance)
        out = (payload, crc_ok, iters, real_bits, data, variance, var_full,
               mean_h)
        if not self.dd:
            return out

        def redecode(rows, state):
            wire = state[3][rows] ^ self._dispersal[None]
            llr2, data2, var2, mh2, vf2 = self._dd_demod(flat[rows],
                                                         slope[rows], wire)
            pay2, crc2, it2, rb2, conv2 = self.llr_to_payload(llr2, data2,
                                                              var2)
            return (pay2, crc2, it2, rb2, data2, var2, vf2, mh2), conv2

        return self._redecode_failed(conv, "dd_rows", self.dd_passes,
                                     redecode, out)[0]

    def _redecode_failed(self, conv, key: str, passes: int, redecode, state):
        """The recovery loop of BICM-ID and DD, passes times: read on the
        host which rows have not converged (stop when none is left), count
        them in recovery[key], and let redecode(rows, state) give their new
        values of the state's tensors and whether they converged; each row
        takes its new values. -> (state, converged)."""
        for _ in range(passes):
            with obs.span("rx.read"):
                rows = torch.nonzero(~conv)[:, 0]
            n_rows = rows.numel()
            if n_rows == 0:
                break
            self.recovery[key] += n_rows
            with obs.span("rx.recovery", n_rows):
                new, conv2 = redecode(rows, state)
                state = tuple(t.index_copy(0, rows, n)
                              for t, n in zip(state, new))
                conv = conv.index_copy(0, rows, conv2)
        return state, conv

    # ------------------------------------------------------------------
    def _to_codeword(self, llr: torch.Tensor) -> torch.Tensor:
        """Wire-order LLRs [B, nBits] -> codeword order [B, N]: the real
        bits, the virtual bits (copies of the first n_virtual), parity."""
        g = self.geom
        return torch.cat([llr[:, : g.n_real], llr[:, : g.n_virtual],
                          llr[:, g.n_real: g.n_real + g.ldpc_p]],
                         dim=-1).to(torch.float32)

    def _bicm_decode(self, llr: torch.Tensor, data: torch.Tensor,
                     variance: torch.Tensor):
        """First layered decode, then bicm_iters BICM-ID passes on the rows
        that have not converged: the decoder's extrinsic (posterior minus
        input, the virtual bits' folded onto the bits they copy) becomes
        per-symbol priors of the log-MAP demapper, whose extrinsic LLRs are
        decoded again; iters accumulate. The demapper's channel metric uses
        variance / llr_scale, in the units of the calibrated LLRs. Which
        rows are left is read on the host once per pass. llr: wire-order
        LLRs; data: equalized symbols, tf-deinterleaved. -> (codeword bits,
        iters, converged)."""
        g = self.geom
        llr_n = self._to_codeword(llr)
        bits, iters, conv, post = self.decoder(llr_n, soft=True)
        nb = self._const.shape[0].bit_length() - 1
        var_eff = variance / self.llr_scale
        nr, nv = g.n_real, g.n_virtual

        def redecode(rows, state):
            bits, iters, llr_n, post = state
            ext = post[rows] - llr_n[rows]
            ext_real = ext[:, :nr].clone()
            ext_real[:, :nv] += ext[:, nr: nr + nv]
            ext_wire = torch.cat([ext_real, ext[:, nr + nv:]], dim=-1)
            la = ext_wire[:, self._bit_perm].reshape(rows.numel(), -1, nb)
            ext2 = psk.demod_full(data[rows], self._const, var_eff[rows], la)
            llr_n2 = self._to_codeword(ext2[:, self._bit_iperm])
            bits2, it2, conv2, post2 = self.decoder(llr_n2, soft=True)
            return (bits2, iters[rows] + it2, llr_n2, post2), conv2

        (bits, iters, _llr_n, _post), conv = self._redecode_failed(
            conv, "bicm_rows", self.bicm_iters, redecode,
            (bits, iters, llr_n, post))
        return bits, iters, conv

    def _decode_codeword(self, llr: torch.Tensor, data: torch.Tensor = None,
                         variance: torch.Tensor = None):
        """Wire-order LLRs -> LDPC, with BICM-ID on the failed rows when
        bicm_iters > 0 and the equalized data and variance are given ->
        (codeword bits, iters, converged)."""
        if self.bicm_iters > 0 and data is not None:
            return self._bicm_decode(llr, data, variance)
        return self.decoder(self._to_codeword(llr))

    def llr_to_payload(self, llr: torch.Tensor, data: torch.Tensor = None,
                       variance: torch.Tensor = None):
        """Deinterleaved LLRs [B, nBits] -> LDPC (BICM-ID on the failed rows
        when bicm_iters > 0 and the equalized data and variance are given)
        -> CRC16 check -> (payload [B, frame_bytes] uint8, crc_ok, iters,
        real bits [B, nReal], converged)."""
        g = self.geom
        b = llr.shape[0]
        bits, iters, conv = self._decode_codeword(llr, data, variance)
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
        return payload, crc_ok, iters.to(torch.int32), real_bits, conv

    @torch.no_grad()
    def bb_decode_bits(self, grid: torch.Tensor) -> torch.Tensor:
        """Baseband-harness decode (reference baseband_test_EsN0): carrier
        grid [B, S, Nc] -> LDPC-decoded bits [B, nReal], with BICM-ID and the
        decision-directed passes when on. The harness has no dispersal, so
        the decoded bits feed the re-estimate directly."""
        g = self.geom
        with ops.full_fp32_matmul():
            llr, (flat, slope, data, variance, _m, _v) = self._ofdm_llr(grid)
            bits, _it, conv = self._decode_codeword(llr, data, variance)

            def redecode(rows, state):
                llr2 = self._dd_demod(flat[rows], slope[rows],
                                      state[0][rows, : g.n_real])[0]
                bits2, _it2, conv2 = self.decoder(self._to_codeword(llr2))
                return (bits2,), conv2

            (bits,), _conv = self._redecode_failed(
                conv, "dd_rows", self.dd_passes if self.dd else 0, redecode,
                (bits,))
        return bits[:, : g.n_real]

    # ------------------------------------------------------------------
    def _rotated_bank(self, tmpl_d: torch.Tensor, freqs, mf_d: int,
                      symbol_step: int = 0):
        """[F, Lp, S] bank of decimated templates [Lp, S] rotated by
        e^{-j w_f t} (CFO hypotheses on the template side), float64 phase
        then the chain's complex type, as the JAX chain builds it on the
        host. t is the sample's time within its symbol (symbol_step 0), or
        its absolute time t = k*mf_d + l*symbol_step, which keeps the phase
        running from one symbol to the next for a coherent sum over
        symbols."""
        dev = tmpl_d.device
        lp, s = tmpl_d.shape
        t = (torch.arange(s, dtype=torch.float64, device=dev)[None] * mf_d
             + torch.arange(lp, dtype=torch.float64, device=dev)[:, None]
             * symbol_step)
        f = torch.as_tensor(np.asarray(freqs, np.float64), device=dev)
        rot = _cis((-(2 * np.pi / self.geom.fs) * f)[:, None, None] * t[None])
        return (tmpl_d.to(torch.complex128)[None] * rot).to(self.cdtype)

    def _refine_bank(self, tmpl_d: torch.Tensor, freqs, mf_d: int):
        """(_rotated_bank(tmpl_d, freqs, mf_d), freqs as a tensor of the
        chain's real type) on tmpl_d's device, built once per (mf_d,
        offsets, device) and kept, as _coherent_banks keeps CONFIG_0's
        banks: a receive then copies nothing from the host."""
        key = ("refine", mf_d, tuple(float(f) for f in freqs), tmpl_d.device)
        return ops.cached(self._bank_cache, key, lambda: (
            self._rotated_bank(tmpl_d, freqs, mf_d),
            torch.as_tensor(np.asarray(freqs, np.float64),
                            dtype=self.real_dtype, device=tmpl_d.device)))

    def _coherent_banks(self, mf_d: int):
        """CONFIG_0's CFO grid [F] (4 Hz steps over +-120 Hz, or +-45 Hz
        with cfo_range "narrow"; a tensor of the chain's real type on its
        device) and its banks at
        mf_d: the preamble as one symbol [F, 1, Lp*S_d], rotated in absolute
        time, the pilot-only symbols [F, Nsymb, S_d], rotated in local
        symbol time, and that bank prepared for the pilot kernel
        (kernels.pilot_bank). Built once per (mf_d, device) and kept, as
        _osc_const keeps the oscillator: a receive then copies nothing from
        the host."""
        def build():
            tmpl_d = self._mf_templates[:, ::mf_d]
            lp, s_d = tmpl_d.shape
            span = 120.0 if self.cfo_range == "wide" else 45.0
            n_h = int(round(span / DEEP_COH_GRID_HZ))
            grid = np.arange(-n_h, n_h + 1) * DEEP_COH_GRID_HZ
            coh = self._rotated_bank(tmpl_d, grid, mf_d,
                                     self._mf_templates.shape[1])
            pil = self._rotated_bank(self._pil_templates[:, ::mf_d], grid,
                                     mf_d)
            return (torch.as_tensor(grid, dtype=self.real_dtype,
                                    device=self.device),
                    coh.reshape(len(grid), 1, lp * s_d), pil,
                    kernels.pilot_bank(pil))
        return ops.cached(self._bank_cache, (mf_d, self.device), build)

    def _coherent_acquire(self, bb_ts: torch.Tensor, mf_d: int, ts_dec: int,
                          sync_limit: int | None = None, stage: str = "full"):
        """CONFIG_0's coherent whole-buffer acquisition (mercury_tpu rx.py
        :1342-1422): the full preamble scored coherently at every lag for
        each row of a 4 Hz CFO grid, max-combined over the grid (lags at or
        past sync_limit interp samples masked out); the top pooled peaks
        re-scored against the pilot lattice. -> (delay [B], coarse CFO [B],
        runner-up delay [B] outside the winner's GI plateau, its CFO [B],
        whether a row has one [B]); stage "arb": the nominees (delay, scan
        score, CFO), each [M, B]. Span rx.deep_scan, n = the rows scanned."""
        g = self.geom
        mf_s = mf_d // ts_dec
        lp, s_tmpl = self._mf_templates.shape
        span = lp * (s_tmpl // mf_d)
        win_g = (bb_ts.shape[-1] // mf_s - span) // 2
        seg_g = bb_ts[:, : (2 * win_g + span) * mf_s: mf_s]
        grid, bank_coh, bank_pil, pil_prep = self._coherent_banks(mf_d)
        with obs.span("rx.deep_scan", bb_ts.shape[0], device=self.device):
            smax, sarg = sync.coherent_scan_max(seg_g, bank_coh, win_g)
            if sync_limit is not None:
                lag = torch.arange(smax.shape[-1], device=smax.device) * mf_d
                smax = torch.where(lag[None] >= sync_limit, -math.inf, smax)
            d_lag, s_top = sync.topk_pooled(smax, 0, DEEP_PIL_TOPM, 8)
            f_top = torch.gather(sarg, 1, d_lag)                # [B, M]
            d_top = d_lag * mf_d                        # interp-rate starts
            if stage == "arb":
                return d_top.T, s_top.T, grid[f_top].T
            score_p = sync.pilot_rescore(bb_ts, d_top, f_top, bank_pil, mf_s,
                                         ts_dec, lp * s_tmpl,
                                         pil_prep)              # [B, M]

            def pick(score):
                i = torch.argmax(score, dim=-1, keepdim=True)
                return (torch.gather(d_top, 1, i)[:, 0],
                        grid[torch.gather(f_top, 1, i)[:, 0]])

            delay, coarse_cfo = pick(score_p)
            far = torch.abs(d_top - delay[:, None]) > g.ngi * g.interp
            delay2, cfo2 = pick(torch.where(far, score_p, -math.inf))
            return delay, coarse_cfo, delay2, cfo2, torch.any(far, dim=-1)

    def _acquire(self, pb: torch.Tensor, sync_limit: int | None = None,
                 stage: str = "full"):
        """Coarse sync + matched-filter arbitration -> (delay [B],
        coarse CFO [B], sync metric [B], rescue). rescue is None, or on the
        coherent path (delay, coarse CFO, eligible) [B] of the runner-up
        candidate. Only frame starts below sync_limit (interp samples) are
        eligible. stage "sync" returns the Schmidl-Cox candidates (starts,
        CFOs: lists of [B]; metric [B]), "arb" the arbitration's stacks."""
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
        pos = torch.arange(met.shape[-1], device=dev)
        if sync_limit is not None:
            met = torch.where(pos[None] * cand_step >= sync_limit, 0.0, met)
        n_k = 3 if self.cfo_range == "wide" else 2
        sym_cand = max((g.nofdm * g.interp) // cand_step, 1)
        met_work = met
        cands, cfo_c, metrics = [], [], []
        for _ in range(n_k):
            idx_k = torch.argmax(met_work, dim=-1)
            cands.append(idx_k * cand_step)
            metrics.append(torch.gather(met, 1, idx_k[:, None])[:, 0])
            cfo_c.append(torch.gather(cfo_arr, 1, idx_k[:, None])[:, 0])
            suppress = torch.abs(pos[None] - idx_k[:, None]) < sym_cand
            met_work = torch.where(suppress, -1.0, met_work)
        if stage == "sync":
            return cands, cfo_c, metrics[0]

        # 2) delay and coarse CFO on the TS baseband decimated to mf_d interp
        # samples
        s_tmpl = self._mf_templates.shape[1]
        mf_d = 2 * ts_dec if s_tmpl % (2 * ts_dec) == 0 else ts_dec
        # sample a little early inside the guard interval, and keep the
        # frame inside the buffer
        max_delay = n - g.nofdm * (g.nsymb + g.preamble_nsymb) * g.interp
        rescue = None
        if self.deep_coherent:
            acq = self._coherent_acquire(bb_ts, mf_d, ts_dec, sync_limit,
                                         stage)
            if stage == "arb":
                return acq
            delay, coarse_cfo, delay2, cfo2, have2 = acq
            rescue = (torch.clamp(delay2 - 8, 0, max_delay), cfo2, have2)
        else:
            acq = self._refine_arbitrate(bb_ts, cands, cfo_c, mf_d, ts_dec,
                                         sync_limit, stage)
            if stage == "arb":
                return acq
            delay, coarse_cfo = acq
        delay = torch.clamp(delay - 8, 0, max_delay)
        return delay, coarse_cfo, metrics[0], rescue

    def _refine_arbitrate(self, bb_ts: torch.Tensor, cands, cfo_c,
                          mf_d: int, ts_dec: int,
                          sync_limit: int | None = None,
                          stage: str = "full"):
        """Matched-filter arbitration over (SC candidate x CFO alias) and, with
        deep sync, the noncoherent whole-buffer scan (its rows join the
        arbitration; with "c2f" its best rows join the candidates instead)
        -> (delay [B], coarse CFO [B]); hypotheses at or past sync_limit
        (interp samples) are out. stage "arb": the (delays, scores, CFOs)
        stacks [rows, B] before the pick. Span rx.nc_scan around the scan,
        n = the rows scanned."""
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
        c2f = self.deep_sync and self.deep_profile == "c2f"
        if self.deep_sync:
            with obs.span("rx.nc_scan", b, device=self.device):
                # whole-buffer known-preamble scan over a static CFO grid
                grid_hz = (DEEP_FULL_GRID_HZ if self.deep_profile == "full"
                           else DEEP_GRID_HZ)
                span = 120.0 if self.cfo_range == "wide" else 30.0
                n_h = int(round(span / grid_hz))
                grid_f = np.arange(-n_h, n_h + 1) * grid_hz
                bank_g, grid_t = self._refine_bank(tmpl_d, grid_f, mf_d)
                win_g = (n_ts // mf_s - lp * s_d) // 2
                seg_g = bb_ts[:, : (2 * win_g + lp * s_d) * mf_s: mf_s]
                delay_g, score_g = sync.matched_filter_refine_bank(
                    seg_g, torch.zeros(b, dtype=torch.int64, device=dev),
                    bank_g, win_g)
                if c2f:
                    # the scan's best rows (lax.top_k's order: ties keep
                    # the lower row) are refined with the Schmidl-Cox
                    # candidates
                    top = torch.sort(score_g, dim=-1, descending=True,
                                     stable=True)[1][:, :C2F_TOPN]
                    d_top = torch.gather(delay_g, 1, top) * mf_d
                    cands = list(cands) + list(d_top.T)
                    cfo_c = list(cfo_c) + list(grid_t[top].T)
        alias = g.fs / ((g.nfft // 2) * g.interp)
        alias_offsets = ((0.0, alias, -alias) if self.cfo_range == "wide"
                         else (0.0,))
        if c2f:
            # +-grid/2 bank offsets: the refined hypotheses as dense as the
            # 15 Hz grid
            alias_offsets += (DEEP_GRID_HZ / 2, -DEEP_GRID_HZ / 2)
        tmpl_bank = self._refine_bank(tmpl_d, alias_offsets, mf_d)[0]
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
            t_seg = (seg_start[:, None].to(self.real_dtype)
                     + lag.to(self.real_dtype) * mf_d)
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
        if self.deep_sync and not c2f:
            delays = torch.cat([delays, delay_g.T * mf_d])
            scores = torch.cat([scores, score_g.T])
            cfos = torch.cat([cfos, grid_t[:, None].expand(-1, b)])
        if sync_limit is not None:
            # a boundary frame's GI plateau can put a candidate just under
            # the limit that then refines past it
            scores = torch.where(delays >= sync_limit, -math.inf, scores)
        if stage == "arb":
            return delays, scores, cfos
        pick = torch.argmax(scores, dim=0)[None]
        delay = torch.gather(delays, 0, pick)[0]
        coarse_cfo = torch.gather(cfos, 0, pick)[0]
        return delay, coarse_cfo

    def _decode_from(self, pb: torch.Tensor, delay: torch.Tensor,
                     coarse_cfo: torch.Tensor, metric: torch.Tensor,
                     stage: str = "full"):
        """Decode at one (start, coarse CFO) hypothesis per row: data FIR,
        Moose, CFO-hypothesis pick, equalize, demap, LDPC (with BICM-ID and
        the DD passes when on), CRC, SNR. stage "hyp" stops after the CFO
        pick: (equalized flat grid, variance, freq)."""
        g = self.geom
        b = pb.shape[0]
        dec0 = self.extract_frame_decimated_pb(pb, delay, g.nsymb)
        t_dec = (delay[:, None].to(self.real_dtype)
                 + torch.arange(dec0.shape[-1], dtype=self.real_dtype,
                                device=pb.device) * g.interp)
        w = 2 * np.pi / g.fs

        def rotate(f: torch.Tensor) -> torch.Tensor:
            return dec0 * _cis(w * f[:, None] * t_dec)

        resid = sync.moose_cfo(rotate(coarse_cfo), g, self._pad_map)
        freq_m = coarse_cfo + resid
        freq_m = torch.where(torch.abs(freq_m) > 0.1, freq_m, 0.0)
        # CFO hypotheses (Moose is unambiguous within +-half a subcarrier)
        subc = g.bandwidth / g.nc
        if self.real_dtype == torch.float32:
            subc = float(np.float32(subc))
        hyps = [freq_m, torch.zeros_like(freq_m)]
        if self.cfo_range == "wide":
            hyps += [freq_m + subc, freq_m - subc]
        hyps = torch.stack(hyps)
        if self.zf:
            eq, variance, mean_h, var_full, freq = self._zf_pick(hyps, rotate)
            flat = slope = None               # no DD pass with zero-forcing
        else:
            freq = self._pilot_pick(hyps, rotate)
            eq, variance, mean_h, var_full, flat, slope = \
                self._grid_stats_internal(self.demod_grid(rotate(freq)))
        if stage == "hyp":
            return eq, variance, freq
        # the JAX receive applies no LLR calibration scale here
        llr, data = self._demap(eq, variance, None)
        payload, crc_ok, iters, real_bits, data, variance, var_full, mean_h = \
            self._decode_llr_dd(llr, flat, slope, data, variance, var_full,
                                mean_h)
        if g.spec.amplitude_restoration:
            snr = 10.0 * torch.log10(1.0 / torch.clamp(var_full, min=1e-30))
        else:
            # QAM: the pilot residual would fold in the LS smoother's
            # estimation bias and under-report strong signals
            snr = self._mer_snr(real_bits, data)
        return RxResult(payload, crc_ok, delay.to(torch.int32), freq, snr,
                        iters, metric, mean_h)

    def _pilot_pick(self, hyps: torch.Tensor, rotate) -> torch.Tensor:
        """The CFO hypothesis [H, B] with the lowest pilot residual, from the
        pilot cells alone (per-symbol partial DFT) -> freq [B]."""
        g = self.geom
        b = hyps.shape[1]
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
            sel.append(torch.mean(torch.abs(y_pil / self._h_eq(h_pil)
                                            - self._pilot_seq) ** 2, dim=-1))
        pick = torch.argmin(torch.stack(sel), dim=0)[None]
        return torch.gather(hyps, 0, pick)[0]

    def _zf_pick(self, hyps: torch.Tensor, rotate):
        """Zero-forcing passes through the pilots, so their residual cannot
        tell hypotheses apart: each gets a full grid, and the one whose
        equalized data lie closest to the constellation (mean hard-decision
        error power) wins. -> (eq, variance, mean_h, var_full, freq) of the
        winner."""
        stats, sel = [], []
        for f_h in hyps:
            st = self.grid_stats(self.demod_grid(rotate(f_h)))
            data_h = st[0][:, self._data_cells]
            d2 = torch.amin(torch.abs(data_h[..., None] - self._const) ** 2,
                            dim=-1)
            sel.append(torch.mean(d2, dim=-1))
            stats.append(st)
        pick = torch.argmin(torch.stack(sel), dim=0)
        rows = torch.arange(hyps.shape[1], device=hyps.device)
        out = [torch.stack(field)[pick, rows] for field in zip(*stats)]
        return (*out, hyps[pick, rows])

    # ------------------------------------------------------------------
    def decode_mfsk(self, grid: torch.Tensor):
        """MFSK carrier grid [B, active_nsymb, Nc] -> (deinterleaved LLRs
        [B, nBits], snr [B] zeros, mean_h [B] ones). A control frame's
        punctured positions, past active_nbits, are erasures (LLR 0;
        reference telecom_system.cc:1184-1193)."""
        g = self.geom
        llr = mfsk.demod(grid, g.mfsk, g.nc, self.active_nsymb,
                         soft=self.mfsk_soft, exp_scale=self.mfsk_exp_scale,
                         clamp=self.mfsk_clamp,
                         noise_pool=self.mfsk_noise_pool)
        llr = torch.nn.functional.pad(llr, (0, g.n_bits - self.active_nbits))
        b = grid.shape[0]
        return (llr[:, self._bit_iperm],
                torch.zeros(b, dtype=self.real_dtype, device=grid.device),
                torch.ones(b, dtype=self.real_dtype, device=grid.device))

    def _decode_mfsk_at(self, pb: torch.Tensor, delay: torch.Tensor,
                        freq: torch.Tensor | None = None):
        """The MFSK frame of each row at delay [B] (interp samples), mixed
        at fc + freq [B] (None: fc alone): data FIR, FFT, soft demod, LDPC,
        CRC -> (payload, crc_ok, iters, snr, mean_h)."""
        frame = self.extract_frame_decimated_pb(pb, delay, self.active_nsymb,
                                                freq)
        llr, snr, mean_h = self.decode_mfsk(self.demod_grid(frame))
        payload, crc_ok, iters, _bits, _conv = self.llr_to_payload(llr)
        return payload, crc_ok, iters, snr, mean_h

    def _as_buffer(self, pb_buffer) -> torch.Tensor:
        """A capture buffer (any real dtype, any device) as a contiguous
        tensor of the chain's real type on the chain's device."""
        return torch.as_tensor(pb_buffer).to(device=self.device,
                                             dtype=self.real_dtype).contiguous()

    @torch.no_grad()
    def decode_at(self, pb_buffer, delay, freq_offset):
        """Decode the frame of each row of pb_buffer [B, n] at a known delay
        [B] (interp samples) and frequency offset [B] or scalar (Hz; each
        row mixed at fc + offset, float64 phase; a Python 0 mixes at fc
        alone) -> (payload, crc_ok, iters, snr_db,
        mean_h). An OFDM mode demaps with the LLR calibration, runs
        BICM-ID and the DD passes as configured, and reports the SNR of the
        JAX decode_at: the MER under zero-forcing, else the pilot residual
        (var_full on PSK modes), not receive's MER on QAM modes."""
        g = self.geom
        pb = self._as_buffer(pb_buffer)
        b = pb.shape[0]
        delay = torch.as_tensor(delay, device=self.device).long().reshape(b)
        freq = self._row_freq(freq_offset, b)
        with ops.full_fp32_matmul():
            if g.spec.is_mfsk:
                return self._decode_mfsk_at(pb, delay, freq)
            frame = self.extract_frame_decimated_pb(pb, delay,
                                                    self.active_nsymb, freq)
            llr, (flat, slope, data, variance, mean_h, var_full) = \
                self._ofdm_llr(self.demod_grid(frame))
            (payload, crc_ok, iters, real_bits, data, variance, var_full,
             mean_h) = self._decode_llr_dd(llr, flat, slope, data, variance,
                                           var_full, mean_h)
            if self.zf:
                snr = self._mer_snr(real_bits, data)
            else:
                var = (var_full if g.spec.amplitude_restoration
                       else variance)
                snr = 10.0 * torch.log10(1.0 / torch.clamp(var, min=1e-30))
        return payload, crc_ok, iters, snr, mean_h

    @torch.no_grad()
    def refine_decode(self, rows, coarse_delay, freq, window: int):
        """Re-sync and decode the sibling frames of a batch (JAX
        refine_decode_jit): each row's delay is refined by the known-preamble
        matched filter over the full-rate IQ within +-window samples of its
        coarse delay [B], the row mixed at fc + freq ([B] or scalar; its
        segment only), then decode_at at the refined delay - 8 ->
        (payload, crc_ok, iters, snr_db, mean_h, delay [B] int32,
        score [B])."""
        pb = self._as_buffer(rows)
        b, n = pb.shape
        lp, s = self._mf_templates.shape
        seg_len = 2 * window + lp * s
        freq = self._row_freq(freq, b)
        coarse = torch.as_tensor(coarse_delay, device=self.device).long()
        start = torch.clamp(coarse - window, 0, max(n - seg_len, 0))
        seg = self.mix_segment(pb, start, seg_len, freq)
        d, score = sync.matched_filter_refine_seg(seg, start,
                                                  self._mf_templates, window)
        return (*self.decode_at(pb, d - 8, freq), d.to(torch.int32), score)

    def _receive_mfsk(self, pb: torch.Tensor,
                      sync_limit: int | None = None) -> RxResult:
        """MFSK receive: the time-sync FIR, the preamble tone metric at
        every symbol-aligned start (those at or past sync_limit interp
        samples masked out), the frame decoded at the best start
        (delay = symbol * Nofdm * interp); with mfsk_sync_cands > 1 the rows
        that fail their CRC are decoded again at the runner-up start
        (outside +-1 symbol of the best), and a row takes that result where
        it passes. Every field then follows the hypothesis the row kept."""
        g = self.geom
        b, n = pb.shape
        sym_len = g.nofdm * g.interp
        bb_ts = kernels.mix_fir_decimate(pb, self._osc_const(n), self._fir_ts,
                                         g.interp)
        met = sync.mfsk_sync_metric(bb_ts, g, decim=g.interp)
        pos = torch.arange(met.shape[-1], device=pb.device)
        if sync_limit is not None:
            met = torch.where(pos[None] * sym_len >= sync_limit, -1.0, met)
        sym_idx = torch.argmax(met, dim=-1)
        delay = sym_idx * sym_len
        metric = torch.gather(met, 1, sym_idx[:, None])[:, 0]
        payload, crc_ok, iters, snr, mean_h = self._decode_mfsk_at(pb, delay)
        freq = torch.zeros(b, dtype=self.real_dtype, device=pb.device)
        state = (payload, crc_ok, delay.to(torch.int32), iters, snr, mean_h,
                 metric)
        if self.mfsk_sync_cands > 1:
            sup = torch.abs(pos[None] - sym_idx[:, None]) <= 1
            sym2 = torch.argmax(torch.where(sup, -1.0, met), dim=-1)

            def redecode(rows, old):
                delay2 = sym2[rows] * sym_len
                p2, ok2, it2, snr2, mh2 = self._decode_mfsk_at(pb[rows],
                                                               delay2)
                new = (p2, ok2, delay2.to(torch.int32), it2, snr2, mh2,
                       met[rows, sym2[rows]])
                return tuple(torch.where(ok2.reshape((-1,) + (1,) * (t.ndim - 1)),
                                         t, o[rows])
                             for t, o in zip(new, old)), ok2

            state, _ok = self._redecode_failed(crc_ok, "mfsk_rows", 1,
                                               redecode, state)
        payload, crc_ok, delay, iters, snr, mean_h, metric = state
        return RxResult(payload, crc_ok, delay, freq, snr, iters, metric,
                        mean_h)

    @torch.no_grad()
    def receive(self, pb_buffer, sync_limit: int | None = None,
                stage: str = "full"):
        """Full RX: sync + CFO + decode -> RxResult. pb_buffer: [B, n], the
        standard buffer or longer (any real dtype; moved to the chain's
        device in its real type).

        sync_limit (interp samples): only frame starts below it are
        eligible, as scale.shard's time-sharded receive asks. stage (OFDM;
        an MFSK mode runs the whole receive) stops early and returns the
        JAX receive_fn's tuple: "sync" the Schmidl-Cox candidates (starts
        and CFOs, lists of [B], metric [B]), "arb" the arbitration stacks
        (delays, scores, CFOs; the coherent nominees [M, B] on CONFIG_0),
        "refine" (delay, coarse CFO, metric) and "hyp" (equalized grid,
        variance, freq) of the first decode.

        On the coherent deep-acquisition path (CONFIG_0), the rows that
        fail their CRC and have an eligible runner-up candidate are decoded
        once more at it, and such a row takes that result where it passes.
        Which rows those are is read on the host (one device sync per call
        on that path); none is decoded again when there are none. On an
        MFSK mode the rows that fail are decoded once more at the runner-up
        sync candidate (_receive_mfsk); which rows failed is likewise read
        on the host. The JAX chain decodes the whole batch again instead; a
        row's result depends on no other row, so the outputs are the
        same."""
        if stage not in STAGES:
            raise ValueError(f"stage must be one of {STAGES}")
        pb = self._as_buffer(pb_buffer)
        with ops.full_fp32_matmul():
            if self.geom.spec.is_mfsk:
                return self._receive_mfsk(pb, sync_limit)
            with obs.span("rx.acquire", device=self.device):
                acq = self._acquire(pb, sync_limit, stage)
            if stage in ("sync", "arb"):
                return acq
            delay, coarse_cfo, metric, rescue = acq
            if stage == "refine":
                return delay, coarse_cfo, metric
            with obs.span("rx.decode", device=self.device):
                out = self._decode_from(pb, delay, coarse_cfo, metric, stage)
            if stage == "hyp" or rescue is None:
                return out
            delay2, cfo2, have2 = rescue
            with obs.span("rx.read"):
                rows = torch.nonzero(~out.crc_ok & have2)[:, 0]
            n_rows = rows.numel()
            if n_rows == 0:
                return out
            with obs.span("rx.rescue", n_rows, device=self.device):
                pb2 = pb if n_rows == pb.shape[0] else pb.index_select(0, rows)
                with obs.span("rx.decode", device=self.device):
                    out2 = self._decode_from(pb2, delay2[rows], cfo2[rows],
                                             metric[rows])
                # out is this call's own: its rows are overwritten in place
                for f in dataclasses.fields(RxResult):
                    a1, a2 = getattr(out, f.name), getattr(out2, f.name)
                    use2 = out2.crc_ok.reshape((-1,) + (1,) * (a1.ndim - 1))
                    a1.index_copy_(0, rows, torch.where(use2, a2, a1[rows]))
                return out
