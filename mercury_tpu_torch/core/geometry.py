"""Static per-mode geometry: every data-dependent structure in the reference
modem (pilot lattice, preamble mask, interleaver walks, channel-estimation
interpolation paths, LDPC graph) is *static per mode*, so it is precomputed
here on host into index maps and dense linear operators that the device compute
path consumes as constants.

Numerology mirrors the reference defaults:
  Nfft=256, gi=1/16, Nc=50, interp=4, bandwidth=48000*50/256/4=2343.75 Hz,
  carrier = bw/2+300 (source/physical_layer/physical_config.cc:30-122).
Frame/pilot tables follow telecom_system.cc:1804-1876, ofdm.cc:904-1238.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from mercury_tpu_torch.core import hostdsp
from mercury_tpu_torch.core.modes import (
    HIGH_DENSITY, LOW_DENSITY, LEAST_SQUARE, ZERO_FORCE,
    MOD_BPSK, MOD_QPSK, MOD_8PSK, MOD_16QAM, MOD_32QAM, MOD_64QAM, MOD_MFSK,
    MODES, ModeSpec, ROBUST_0,
)
from mercury_tpu_torch.core.prng import GlibcRandom

# Cell types (physical_defines.h:51-57)
DATA, PILOT, CONFIG, ZERO, PREAMBLE = 0, 1, 2, 3, 4

N_LDPC = 1600

# Default numerology (physical_config.cc)
NFFT = 256
GI = 1.0 / 16.0
NC = 50
INTERP = 4
BANDWIDTH = 48000.0 * 50.0 / NFFT / INTERP          # 2343.75 Hz
CARRIER_FREQ = BANDWIDTH / 2 + 300.0                 # 1471.875 Hz
CARRIER_AMP = math.sqrt(2.0)
PILOT_BOOST = 1.33                                   # stored as float32 in ref
PREAMBLE_BOOST = math.sqrt(2.0)
OUTPUT_POWER_WATT = 0.1
PREAMBLE_PAPR_CUT = 7.0
DATA_PAPR_CUT = 10.0
START_SHIFT = 1
PILOT_SEED = 0
PREAMBLE_SEED = 1
DISPERSAL_SEED = 0
LS_WINDOW = 21  # 20 odd-ified (telecom_system.cc:2799-2809)

# Nsymb per modulation (telecom_system.cc:1818-1835)
_NSYMB = {
    HIGH_DENSITY: {MOD_BPSK: 48, MOD_QPSK: 24, MOD_8PSK: 16, MOD_16QAM: 12,
                   MOD_32QAM: 9, MOD_64QAM: 8},
    LOW_DENSITY: {MOD_BPSK: 40, MOD_QPSK: 20, MOD_8PSK: 16, MOD_16QAM: 10,
                  MOD_32QAM: 9, MOD_64QAM: 8},
}
# Pilot Dy per modulation (telecom_system.cc:1848-1869); Dx is always 1
_DY = {
    HIGH_DENSITY: {MOD_BPSK: 3, MOD_QPSK: 3, MOD_8PSK: 3, MOD_16QAM: 3,
                   MOD_32QAM: 3, MOD_64QAM: 3},
    LOW_DENSITY: {MOD_BPSK: 5, MOD_QPSK: 5, MOD_8PSK: 3, MOD_16QAM: 5,
                  MOD_32QAM: 3, MOD_64QAM: 3},
}


def psk_constellation(m: int) -> np.ndarray:
    """Unit-power constellation tables (reference: psk.cc:65-256).

    The tables are index->point maps (Gray-ish); normalization uses float32
    like the reference's `float power_normalization_value`.
    """
    if m == MOD_BPSK:
        pts = [1, -1]
    elif m == MOD_QPSK:
        pts = [-1 + 1j, -1 - 1j, 1 + 1j, 1 - 1j]
    elif m == MOD_8PSK:
        s = math.sqrt(2.0) / 2.0
        pts = [(-1 - 1j) * s, -1, 1j, (-1 + 1j) * s, -1j, (1 - 1j) * s, (1 + 1j) * s, 1]
    elif m == MOD_16QAM:
        re = [-3, -3, -3, -3, -1, -1, -1, -1, 3, 3, 3, 3, 1, 1, 1, 1]
        im = [3, 1, -3, -1, 3, 1, -3, -1, 3, 1, -3, -1, 3, 1, -3, -1]
        pts = [r + 1j * i for r, i in zip(re, im)]
    elif m == MOD_32QAM:
        re = [-3, -1, -3, -1, -5, -5, -5, -5, -1, -1, -1, -1, -3, -3, -3, -3,
              3, 1, 3, 1, 5, 5, 5, 5, 1, 1, 1, 1, 3, 3, 3, 3]
        im = [5, 5, -5, -5, 3, 1, -3, -1, 3, 1, -3, -1, 3, 1, -3, -1,
              5, 5, -5, -5, 3, 1, -3, -1, 3, 1, -3, -1, 3, 1, -3, -1]
        pts = [r + 1j * i for r, i in zip(re, im)]
    elif m == MOD_64QAM:
        res = [-7, -5, -1, -3, 7, 5, 1, 3]
        ims = [7, 5, 1, 3, -7, -5, -1, -3]
        pts = [r + 1j * i for r in res for i in ims]
    else:
        raise ValueError(f"unknown modulation {m}")
    c = np.array(pts, dtype=np.complex128)
    norm = np.float32(1.0) / np.float32(np.sqrt(np.float32(np.sum(np.abs(c) ** 2).real) / np.float32(m)))
    return c * np.float64(norm)


def _pilot_type_map(nc: int, nsymb: int, dx: int, dy: int) -> np.ndarray:
    """Pilot lattice (reference: cl_pilot_configurator::configure, ofdm.cc:976-1064).

    Defaults: first/last row, first/second col = DATA; last col = AUTO
    (becomes COPY_FIRST_COL when the last column has <2 pilots).
    """
    nc_max = max(nc, nsymb)
    grid = np.full((nc_max, nc_max), DATA, dtype=np.int8)  # [row(sym), col(carrier)]
    x = y = 0
    while x < nc_max and y < nc_max:
        # reference marks y+k*dy (down) and y-k*dy (up) in column x —
        # together: every row congruent to y mod dy
        grid[y % dy::dy, x] = PILOT
        y += 1
        x += dx

    pilot_count = int(np.sum(grid[:nsymb, nc - 1] == PILOT))
    if pilot_count < 2:  # last_col == AUTO_SELLECT -> COPY_FIRST_COL
        grid[:, nc - 1] = grid[:, 0]

    return grid[:nsymb, :nc].copy()


def interleaver_perm(n_items: int, block_size: int) -> np.ndarray:
    """Permutation p with out[i] = in[p[i]] for the reference block interleaver
    (interleaver.cc:26-41): out[j*nBlocks+i] = in[i*block+j], tail unchanged."""
    n_blocks = n_items // block_size
    p = np.arange(n_items)
    idx = np.arange(n_blocks * block_size)
    j, i = idx // n_blocks, idx % n_blocks
    p[:n_blocks * block_size] = i * block_size + j
    return p


def _interp_linear_col(vals: np.ndarray, measured: np.ndarray) -> None:
    """Column interpolation/extrapolation over the symbol axis, vectorized over a
    trailing basis axis (reference: interpolator.cc:70-161). vals: [rows, B],
    measured: bool [rows]. Modifies vals in place for non-measured rows."""
    rows = np.nonzero(measured)[0]
    assert len(rows) >= 2, "column needs >=2 measured pilots"
    nrows = vals.shape[0]
    for a, b in zip(rows[:-1], rows[1:]):
        for i in range(a + 1, b):
            t = (i - a) / (b - a)
            vals[i] = vals[a] + (vals[b] - vals[a]) * t
    a, b = rows[0], rows[1]
    for i in range(0, a):
        t = (i - a) / (b - a)
        vals[i] = vals[a] + (vals[b] - vals[a]) * t
    a, b = rows[-2], rows[-1]
    for i in range(b + 1, nrows):
        t = (i - a) / (b - a)
        vals[i] = vals[a] + (vals[b] - vals[a]) * t


def _build_interp_operator(types: np.ndarray, dx: int) -> np.ndarray:
    """Dense operator W [nsymb*nc, nPilots]: measured pilot-cell values ->
    fully interpolated channel grid, replicating ZF/LS interpolation stages
    (ofdm.cc:1287-1309/1425-1447). Linear, real coefficients."""
    nsymb, nc = types.shape
    pilot_cells = np.nonzero(types.ravel() == PILOT)[0]
    npil = len(pilot_cells)
    w = np.zeros((nsymb, nc, npil), dtype=np.float64)
    # seed measured cells with one-hot basis vectors
    for k, cell in enumerate(pilot_cells):
        w[cell // nc, cell % nc, k] = 1.0
    measured = types == PILOT

    cols_done = np.zeros(nc, dtype=bool)
    for j in range(nc):
        if j % dx == 0 or j == nc - 1:
            _interp_linear_col(w[:, j, :], measured[:, j])
            cols_done[j] = True
    # bilinear fill between pilot columns (no-op when dx == 1)
    for j in range(0, nc, dx):
        col2 = j + dx if j + dx < nc else (nc - 1 if j != nc - 1 else None)
        if col2 is None:
            continue
        for jj in range(j + 1, col2):
            for i in range(nsymb):
                t = (jj - j) / (col2 - j)
                w[i, jj, :] = w[i, j, :] + (w[i, col2, :] - w[i, j, :]) * t
    return w.reshape(nsymb * nc, npil)


def _build_ls_operator(types: np.ndarray, pilot_seq: np.ndarray,
                       win: int | tuple[int, int]) -> np.ndarray:
    """Dense operator L [nPilots, nPilots]: received pilot-cell values -> LS
    channel estimates at pilot cells (reference: ofdm.cc:1315-1422).
    H_p = sum_w (x_w / sum_w x_w^2) * y_w over the (win x win) window.
    win may be (win_symbols, win_carriers) — a narrow time span makes a
    TRACKING estimator for fading channels (not in the reference, whose
    window is square, telecom_system.cc:2799-2809)."""
    nsymb, nc = types.shape
    win_s, win_c = (win, win) if isinstance(win, int) else win
    pilot_rc = np.argwhere(types == PILOT)  # row-major order == sequence order
    cell_to_seq = {(r, c): k for k, (r, c) in enumerate(pilot_rc)}
    npil = len(pilot_rc)
    l_op = np.zeros((npil, npil), dtype=np.float64)
    half_s, half_c = win_s // 2, win_c // 2
    # reference iterates j (carrier) outer, i (symbol) inner, but the estimate
    # for each pilot is independent of iteration order
    for k, (i, j) in enumerate(pilot_rc):
        r0, r1 = max(0, i - half_s), min(nsymb - 1, i + half_s)
        c0, c1 = max(0, j - half_c), min(nc - 1, j + half_c)
        idxs, xs = [], []
        for r in range(r0, r1 + 1):
            for c in range(c0, c1 + 1):
                if types[r, c] == PILOT:
                    w_idx = cell_to_seq[(r, c)]
                    idxs.append(w_idx)
                    xs.append(pilot_seq[w_idx].real)  # pilots are real BPSK
        xs = np.array(xs)
        l_op[k, idxs] = xs / np.sum(xs * xs)
    return l_op


@dataclass
class MfskParams:
    """MFSK mode parameters (reference: mfsk.cc:49-159)."""
    m: int
    nbits: int
    nstreams: int
    tone_hop_step: int
    stream_offsets: np.ndarray
    preamble_tones: np.ndarray
    ack_tones: np.ndarray
    break_tones: np.ndarray
    ack_pattern_nsymb: int = 16


def mfsk_params(m: int, nc: int, nstreams: int) -> MfskParams:
    nbits = m.bit_length() - 1
    hop = 13 if m == 32 else (7 if m == 16 else 1)
    goff = max(0, (nc - nstreams * m) // 2)
    offsets = np.array([goff + k * m for k in range(nstreams)], dtype=np.int32)
    if m == 32:
        pre = [4, 20, 12, 28]
        ack = [8, 14, 10, 24, 26, 2, 18, 30]
        brk = [12, 28, 4, 6, 20, 16, 22, 30]
    elif m == 16:
        pre = [2, 10, 6, 14]
        ack = [4, 7, 5, 12, 13, 1, 9, 15]
        brk = [6, 14, 2, 3, 10, 8, 11, 15]
    else:
        pre = [(i * m // 4 + m // 8) % m for i in range(4)]
        ack = [(i * m // 8 + 1) % m for i in range(8)]
        brk = [(a + m // 2) % m for a in ack]
    return MfskParams(m, nbits, nstreams, hop, offsets,
                      np.array(pre, np.int32), np.array(ack, np.int32),
                      np.array(brk, np.int32))


@dataclass
class ModeGeometry:
    """All static structure for one (config, pilot_density)."""
    spec: ModeSpec
    pilot_density: int
    # scalar geometry
    nc: int
    nfft: int
    ngi: int
    nofdm: int
    nsymb: int
    preamble_nsymb: int
    interp: int
    n_data: int          # data cells per frame
    n_bits: int          # coded bits per frame (== used LDPC bits)
    n_real: int          # payload+crc bits (nBits - P)
    n_virtual: int       # duplicated bits (N - nBits)
    frame_bytes: int     # payload bytes (excl. CRC16)
    buffer_nsymb: int
    total_frame_size: int
    ldpc_k: int
    ldpc_p: int
    bit_block: int
    tf_block: int
    bandwidth: float
    fs: float
    fc: float
    time_sync_nsymb: int
    # maps / tables (numpy on host; converted to jnp by consumers)
    frame_types: np.ndarray
    data_cells: np.ndarray
    pilot_cells: np.ndarray
    pilot_seq: np.ndarray
    preamble_vals: np.ndarray
    preamble_types: np.ndarray
    dispersal: np.ndarray
    bit_perm: np.ndarray
    bit_iperm: np.ndarray
    tf_perm: np.ndarray
    tf_iperm: np.ndarray
    pad_map: np.ndarray
    fir_tx1: np.ndarray
    fir_tx2: np.ndarray
    fir_rx_data: np.ndarray
    fir_rx_ts: np.ndarray
    constellation: np.ndarray | None
    pre_eq: np.ndarray | None
    est_op: np.ndarray | None      # [nsymb*nc, nPilots] real; includes 1/pilot or LS
    mfsk: MfskParams | None
    ctrl_nsymb: int = 0
    # effective RX channel estimator (may differ from spec.channel_estimator:
    # the estimator is receiver-side only, so wire compatibility does not pin
    # it — see build_geometry(estimator=...))
    estimator: int = LEAST_SQUARE

    @property
    def n_pilots(self) -> int:
        return len(self.pilot_cells)

    @property
    def frame_samples_base(self) -> int:
        """Baseband samples per frame (preamble + data) before interpolation."""
        return self.nofdm * (self.nsymb + self.preamble_nsymb)

    # --- rate/duration parameters (reference calculate_parameters,
    # telecom_system.cc:1543-1570; per-density bitrates common_defines.h:150-189)
    def _rate_terms(self) -> tuple[float, float]:
        if self.spec.is_mfsk:
            return float(self.nsymb), float(self.mfsk.nbits * self.mfsk.nstreams)
        return float(self.n_data), float(np.log2(self.spec.modulation))

    @property
    def tf_seconds(self) -> float:
        """Frame duration Tf = Ts * (Nsymb + preamble_Nsymb)."""
        tu = self.nc / self.bandwidth
        ts = tu * (1.0 + self.ngi / self.nfft)
        return ts * (self.nsymb + self.preamble_nsymb)

    @property
    def ldpc_real_cr(self) -> float:
        """Effective code rate incl. CRC16 outer code and virtual bits."""
        n_eff, log2m = self._rate_terms()
        return (n_eff * log2m - self.ldpc_p - 16.0) / (n_eff * log2m)

    @property
    def rb(self) -> float:
        """Gross bitrate (bps) over the air."""
        n_eff, log2m = self._rate_terms()
        return n_eff * log2m / self.tf_seconds

    @property
    def rbc(self) -> float:
        """Net payload bitrate (bps), excl. LDPC parity and CRC16."""
        return self.rb * self.ldpc_real_cr


def _compute_pre_eq(rng: GlibcRandom, nc: int, nfft: int, ngi: int, mlog2: int,
                    const: np.ndarray, fir_tx1: np.ndarray, fir_tx2: np.ndarray,
                    fir_rx_data: np.ndarray, fs: float, fc: float,
                    n_tries: int = 1000) -> np.ndarray:
    """Pre-equalization probe: average TX->RX channel of the FIR cascade
    (reference: telecom_system.cc:3108-3145). Consumes the PRNG stream left
    from pilot-sequence generation."""
    nofdm = nfft + ngi
    acc = np.zeros(nc, dtype=np.complex128)
    # vectorized batch: draw all bits first (PRNG is sequential)
    bits = rng.bits(n_tries * nc * mlog2).reshape(n_tries, nc * mlog2)
    powers = 1 << np.arange(mlog2)[::-1]
    for t in range(n_tries):
        idx = bits[t].reshape(nc, mlog2) @ powers
        syms = const[idx]
        td = hostdsp.symbol_mod(syms, nfft, ngi, START_SHIFT)
        pb = hostdsp.baseband_to_passband(td, fs, fc, CARRIER_AMP, INTERP, 0)
        f1 = hostdsp.fir_apply(pb, fir_tx1)
        f2 = hostdsp.fir_apply(f1, fir_tx2)
        bb = hostdsp.passband_to_baseband(f2, fs, fc, CARRIER_AMP, INTERP, fir_rx_data)
        rx = hostdsp.symbol_demod(bb, nfft, ngi, nc, START_SHIFT)
        acc += syms / rx
    return acc / n_tries


_GEOMETRY_CACHE: dict[tuple, ModeGeometry] = {}


def build_geometry(config: int, pilot_density: int = HIGH_DENSITY,
                   with_pre_eq: bool = True,
                   estimator: str = "auto",
                   ls_window: tuple[int, int] | None = None,
                   carrier_offset_hz: float = 0.0) -> ModeGeometry:
    """estimator: "auto" (default) uses the windowed-LS estimator for every
    OFDM mode — including CONFIG_15/16, where the reference's table says
    zero-force. The estimator is receiver-side only (no wire impact), and
    LS over the 21x21 pilot window is measured ~2 dB more sensitive than ZF
    at 16QAM/32QAM rate-14/16 (docs/esn0_reconciliation.md §5b). "reference"
    reproduces the reference's per-config estimator choice exactly.

    ls_window (symbols, carriers) overrides the LS smoothing span (default
    21x21, the reference's). A narrow time span — e.g. (5, 21) — makes a
    tracking estimator that follows fading inside a frame, at some AWGN
    sensitivity cost; pair it with RxChain(dd=..., dd_window=...) for the
    full fading profile (docs/fading_r2.md)."""
    key = (config, pilot_density, with_pre_eq, estimator, ls_window,
           carrier_offset_hz)
    if key in _GEOMETRY_CACHE:
        return _GEOMETRY_CACHE[key]

    spec = MODES[config]
    if estimator == "auto":
        eff_est = LEAST_SQUARE
    elif estimator == "reference":
        eff_est = spec.channel_estimator
    else:
        raise ValueError("estimator must be 'auto' or 'reference'")
    nc, nfft = NC, NFFT
    ngi = int(nfft * GI)
    nofdm = nfft + ngi
    fs = INTERP * (BANDWIDTH / nc) * nfft  # 48000 (telecom_system.cc:1569)
    # carrier_offset_hz: radio-type passband shift (reference
    # main.cc:200-218 / physical_config.cc:88 — sBitx radios put the modem
    # at +15 kHz); flows into the passband mixers, the TX band-edge FIRs
    # and the pre-equalization probe via fc
    fc = CARRIER_FREQ + carrier_offset_hz

    mfsk = None
    if spec.is_mfsk:
        mfsk = mfsk_params(spec.mfsk_m, nc, spec.mfsk_nstreams)
        bps = mfsk.nbits * mfsk.nstreams
        nsymb = N_LDPC // bps
        dx, dy = 1, nsymb
        n_data = nsymb
        n_bits = nsymb * bps
    else:
        nsymb = _NSYMB[pilot_density][spec.modulation]
        dx, dy = 1, _DY[pilot_density][spec.modulation]
        n_data = n_bits = 0  # filled below from the pilot map

    pre_nsymb = spec.preamble_nsymb

    # --- pilot lattice & frame map
    frame_types = _pilot_type_map(nc, nsymb, dx, dy)
    flat = frame_types.ravel()
    pilot_cells = np.nonzero(flat == PILOT)[0].astype(np.int32)
    data_cells = np.nonzero(flat == DATA)[0].astype(np.int32)
    if not spec.is_mfsk:
        n_data = len(data_cells)
        n_bits = int(n_data * math.log2(spec.modulation))

    # --- preamble mask (even FFT bins only) + sequences
    pad_map = hostdsp.zero_pad_map(nfft, nc, START_SHIFT)
    pre_mask = (pad_map % 2) == 0  # PREAMBLE where the FFT bin is even
    preamble_types = np.where(pre_mask, PREAMBLE, ZERO).astype(np.int8)
    preamble_types = np.tile(preamble_types, (pre_nsymb, 1))

    rng = GlibcRandom(PREAMBLE_SEED)
    # QPSK sequence: complex(2*r%2-1, 2*r%2-1)/sqrt(2); g++ evaluates the
    # constructor args right-to-left, so the imaginary part draws first
    # (verified against golden vectors).
    draws = rng.bits(2 * pre_nsymb * nc).reshape(pre_nsymb * nc, 2)
    seq = ((2 * draws[:, 1].astype(np.float64) - 1)
           + 1j * (2 * draws[:, 0].astype(np.float64) - 1)) / math.sqrt(2.0)
    preamble_vals = np.zeros((pre_nsymb, nc), dtype=np.complex128)
    pre_cells = np.nonzero(preamble_types.ravel() == PREAMBLE)[0]
    preamble_vals.ravel()[pre_cells] = seq[: len(pre_cells)]

    # --- pilot sequence: DBPSK random walk (ofdm.cc:940-952)
    rng_p = GlibcRandom(PILOT_SEED)
    raw = rng_p.bits(len(pilot_cells)).astype(np.int64)
    walk = np.bitwise_xor.accumulate(raw) if len(raw) else raw
    boost64 = np.float64(np.float32(PILOT_BOOST))
    pilot_seq = (2.0 * walk - 1.0).astype(np.complex128) * boost64

    # --- dispersal sequence (telecom_system.cc:1961-1966)
    dispersal = GlibcRandom(DISPERSAL_SEED).bits(N_LDPC)

    # --- LDPC sizes
    ldpc_k = spec.ldpc_k
    ldpc_p = N_LDPC - ldpc_k
    n_real = n_bits - ldpc_p
    n_virtual = N_LDPC - n_bits
    frame_bytes = (n_real - 16) // 8  # CRC16 outer code reserves 16 bits

    # --- interleavers (block sizes: telecom_system.cc:2910-2911)
    bit_block = n_bits // 10
    tf_block = n_data // 10
    bit_perm = interleaver_perm(n_bits, bit_block)
    bit_iperm = np.argsort(bit_perm)
    tf_perm = interleaver_perm(n_data, tf_block)
    tf_iperm = np.argsort(tf_perm)

    # --- FIR filters (physical_config.cc:93-113)
    fir_rx_ts = hostdsp.design_fir(fs, 3000, 0.9 * BANDWIDTH / 2, "lpf", "hamming")
    fir_rx_data = hostdsp.design_fir(fs, 3000, 1.0 * BANDWIDTH / 2, "lpf", "hamming")
    fir_tx1 = hostdsp.design_fir(fs, 1000, fc - BANDWIDTH / 2, "hpf", "hamming")
    fir_tx2 = hostdsp.design_fir(fs, 1000, fc + BANDWIDTH / 2, "lpf", "blackman")

    # --- buffer sizing (data_container.cc:133-143)
    sym_time_ms = 1000.0 * nofdm * INTERP / 48000.0
    turnaround = int(math.ceil(1200.0 / sym_time_ms)) + 4
    frame_symb = pre_nsymb + nsymb
    buffer_nsymb = max(frame_symb * 2, frame_symb + turnaround, 32)
    total_frame_size = nofdm * frame_symb * INTERP

    # --- constellation / channel estimation / pre-eq (OFDM modes only)
    constellation = pre_eq = est_op = None
    if not spec.is_mfsk:
        constellation = psk_constellation(spec.modulation)
        w = _build_interp_operator(frame_types, dx)
        if eff_est == ZERO_FORCE:
            est_op = w / pilot_seq.real[None, :]
        else:
            l_op = _build_ls_operator(frame_types, pilot_seq,
                                      ls_window or LS_WINDOW)
            est_op = w @ l_op
        if with_pre_eq:
            # PRNG continues from the pilot-sequence state (telecom_system.cc
            # init() ordering: ofdm.init -> ... -> get_pre_equalization_channel)
            pre_eq = _compute_pre_eq(
                rng_p, nc, nfft, ngi, int(math.log2(spec.modulation)),
                constellation, fir_tx1, fir_tx2, fir_rx_data, fs, fc)

    geom = ModeGeometry(
        spec=spec, pilot_density=pilot_density,
        nc=nc, nfft=nfft, ngi=ngi, nofdm=nofdm, nsymb=nsymb,
        preamble_nsymb=pre_nsymb, interp=INTERP,
        n_data=n_data, n_bits=n_bits, n_real=n_real, n_virtual=n_virtual,
        frame_bytes=frame_bytes, buffer_nsymb=buffer_nsymb,
        total_frame_size=total_frame_size,
        ldpc_k=ldpc_k, ldpc_p=ldpc_p, bit_block=bit_block, tf_block=tf_block,
        bandwidth=BANDWIDTH, fs=fs, fc=fc, time_sync_nsymb=nsymb,
        frame_types=frame_types, data_cells=data_cells, pilot_cells=pilot_cells,
        pilot_seq=pilot_seq, preamble_vals=preamble_vals,
        preamble_types=preamble_types, dispersal=dispersal,
        bit_perm=bit_perm, bit_iperm=bit_iperm, tf_perm=tf_perm, tf_iperm=tf_iperm,
        pad_map=pad_map, fir_tx1=fir_tx1, fir_tx2=fir_tx2,
        fir_rx_data=fir_rx_data, fir_rx_ts=fir_rx_ts,
        constellation=constellation, pre_eq=pre_eq, est_op=est_op, mfsk=mfsk,
        ctrl_nsymb=(spec.ctrl_nbits // (mfsk.nbits * mfsk.nstreams) if mfsk else 0),
        estimator=eff_est,
    )
    _GEOMETRY_CACHE[key] = geom
    return geom
