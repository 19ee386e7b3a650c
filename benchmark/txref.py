"""The benchmark's own plain Mercury OFDM transmitter and channel, frozen.

It makes the traffic's frames and is the reference that `correct` is judged
by: it knows every payload it sent. Nothing here imports the program under
test, so a change to the program's transmitter cannot change the inputs.
It follows the upstream modem's transmit chain (Rhizomatica/mercury,
`source/physical_layer/telecom_system.cc` transmit_byte/transmit_bit,
`ofdm.cc`, `fir_filter.cc`, `psk.cc`, `interleaver.cc`; the mode table
`telecom_system.cc:2487-2645`):

CRC16 -> energy dispersal -> virtual-bit duplication -> IRA-LDPC encode ->
bit interleave -> PSK/QAM map -> time/frequency interleave -> pilots and
pre-equalization -> IFFT + cyclic prefix -> power staging -> x4 linear
interpolation -> carrier mix -> PAPR clip -> TX FIR cascade.

The per-mode tables are built on the host in float64 (numpy); the frames are
computed with plain torch operations in float64 on any device and handed
out as float32, the capture's type.
"""

from __future__ import annotations

import math
import pathlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

N_LDPC = 1600
# the numerology every OFDM mode shares (physical_config.cc:30-122)
NFFT, NC, INTERP = 256, 50, 4
NGI = NFFT // 16
BANDWIDTH = 48000.0 * NC / NFFT / INTERP             # 2343.75 Hz
FC = BANDWIDTH / 2 + 300.0                            # 1471.875 Hz
FS = INTERP * (BANDWIDTH / NC) * NFFT                 # 48000 Hz
PILOT_BOOST = 1.33
START_SHIFT = 1
PILOT_SEED, PREAMBLE_SEED, DISPERSAL_SEED = 0, 1, 0
AMP_DATA = math.sqrt(0.1)                             # output power 0.1 W
AMP_PRE = AMP_DATA * math.sqrt(2.0)
PAPR_PRE_DB, PAPR_DATA_DB = 7.0, 10.0
# data symbols a frame and pilot spacing Dy (telecom_system.cc:1818-1869),
# by points of the constellation; Dx is 1
NSYMB = {"high": {2: 48, 4: 24, 8: 16, 16: 12, 32: 9, 64: 8},
         "low": {2: 40, 4: 20, 8: 16, 16: 10, 32: 9, 64: 8}}
DY = {"high": {2: 3, 4: 3, 8: 3, 16: 3, 32: 3, 64: 3},
      "low": {2: 5, 4: 5, 8: 3, 16: 5, 32: 3, 64: 3}}
DATA, PILOT = 0, 1
LDPC_TABLES = pathlib.Path(__file__).resolve().parent / "data" / "ldpc_tables.npz"


def glibc_random_bits(seed: int, n: int) -> np.ndarray:
    """The first n outputs of glibc's TYPE_3 random() % 2 after
    srandom(seed) (os_interop.cc:151-415), for seeds below 2**31."""
    r = [seed or 1]
    for _ in range(30):
        hi, lo = divmod(r[-1], 127773)
        w = 16807 * lo - 2836 * hi
        r.append(w + 2147483647 if w < 0 else w)
    r += r[:3]
    for i in range(34, 344 + n):
        r.append((r[i - 31] + r[i - 3]) & 0xFFFFFFFF)
    return np.asarray([(v >> 1) & 1 for v in r[344:]], np.int64)


def design_fir(fs: float, transition: float, cut: float, ftype: str,
               window: str) -> np.ndarray:
    """Windowed sinc (fir_filter.cc:45-165); 'hpf' by spectral inversion."""
    ntaps = int(4.0 / (transition / (fs / 2.0)))
    ntaps += ntaps % 2 == 0
    h = np.empty(ntaps)
    half = ntaps // 2
    h[half] = 1.0
    i = np.arange(half)
    arg = 2 * np.pi * cut * (half - i) / fs
    h[:half] = np.sin(arg) / arg
    h[ntaps - i - 1] = h[:half]
    h /= h.sum()
    if ftype == "hpf":
        h = -h
        h[(ntaps - 1) // 2] += 1
    n = np.arange(ntaps)
    if window == "hamming":
        h *= 0.54 - 0.46 * np.cos(2 * np.pi * n / (ntaps - 1))
    else:                                             # blackman
        h *= (0.42 - 0.5 * np.cos(2 * np.pi * n / ntaps)
              + 0.08 * np.cos(4 * np.pi * n / ntaps))
    return h


def constellation(m: int) -> np.ndarray:
    """Index -> point maps of psk.cc:65-256, unit power (float32 norm)."""
    if m == 2:
        pts = [1, -1]
    elif m == 4:
        pts = [-1 + 1j, -1 - 1j, 1 + 1j, 1 - 1j]
    elif m == 8:
        s = math.sqrt(2.0) / 2.0
        pts = [(-1 - 1j) * s, -1, 1j, (-1 + 1j) * s, -1j, (1 - 1j) * s,
               (1 + 1j) * s, 1]
    elif m == 16:
        re = [-3] * 4 + [-1] * 4 + [3] * 4 + [1] * 4
        im = [3, 1, -3, -1] * 4
        pts = [a + 1j * b for a, b in zip(re, im)]
    elif m == 32:
        re = [-3, -1, -3, -1, -5, -5, -5, -5, -1, -1, -1, -1, -3, -3, -3, -3,
              3, 1, 3, 1, 5, 5, 5, 5, 1, 1, 1, 1, 3, 3, 3, 3]
        im = [5, 5, -5, -5, 3, 1, -3, -1, 3, 1, -3, -1, 3, 1, -3, -1] * 2
        pts = [a + 1j * b for a, b in zip(re, im)]
    elif m == 64:
        pts = [a + 1j * b for a in [-7, -5, -1, -3, 7, 5, 1, 3]
               for b in [7, 5, 1, 3, -7, -5, -1, -3]]
    else:
        raise ValueError(f"no constellation of {m} points")
    c = np.asarray(pts, np.complex128)
    p = np.float32(np.sum(np.abs(c) ** 2)) / np.float32(m)
    return c * np.float64(np.float32(1.0) / np.float32(np.sqrt(p)))


def interleaver_perm(n: int, block: int) -> np.ndarray:
    """out[i] = in[p[i]] of interleaver.cc:26-41 (tail unchanged)."""
    nb = n // block
    p = np.arange(n)
    idx = np.arange(nb * block)
    p[:nb * block] = (idx % nb) * block + idx // nb
    return p


def pad_map() -> np.ndarray:
    """FFT bin of each carrier (ofdm.cc:379-411)."""
    j = np.arange(NC)
    return np.where(j < NC // 2, j + NFFT - NC // 2, j - NC // 2 + START_SHIFT)


def _fir_same(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Centre-aligned 'same' FIR of real or complex rows [B, n]."""
    if x.is_complex():
        return torch.complex(_fir_same(x.real, h), _fir_same(x.imag, h))
    t = h.shape[0]
    c = (t - 1) // 2
    y = F.conv1d(F.pad(x[:, None], (t - 1 - c, c)), h.flip(0)[None, None])
    return y[:, 0]


def _interp(x: torch.Tensor, rate: int) -> torch.Tensor:
    """Linear x rate upsampler; the last sample extrapolated from the final
    two (ofdm.cc:2278-2291)."""
    n = x.shape[-1]
    f = torch.arange(rate, dtype=torch.float64, device=x.device) / rate
    body = (x[:, :-1, None] + (x[:, 1:, None] - x[:, :-1, None]) * f)
    tail = x[:, n - 2, None] + (x[:, n - 1, None] - x[:, n - 2, None]) * (1 + f)
    return torch.cat([body.reshape(x.shape[0], -1), tail], dim=-1)


def _mix_up(bb: torch.Tensor) -> torch.Tensor:
    ph = (2 * math.pi * FC / FS) * torch.arange(
        bb.shape[-1], dtype=torch.float64, device=bb.device)
    return math.sqrt(2.0) * (bb.real * torch.cos(ph) + bb.imag * torch.sin(ph))


def _clip(x: torch.Tensor, papr_db: float) -> torch.Tensor:
    peak = torch.sqrt(torch.mean(x * x, -1, keepdim=True)
                      * 10 ** (papr_db / 10))
    return torch.minimum(torch.maximum(x, -peak), peak)


def _ofdm_mod(cells: torch.Tensor, pmap: torch.Tensor) -> torch.Tensor:
    """[B, S, Nc] -> [B, S * (Nfft + Ngi)]: unnormalized IFFT + prefix."""
    spec = torch.zeros((*cells.shape[:-1], NFFT), dtype=cells.dtype,
                       device=cells.device)
    spec[..., pmap] = cells
    td = torch.fft.ifft(spec, dim=-1) * NFFT
    return torch.cat([td[..., NFFT - NGI:], td], -1).reshape(cells.shape[0], -1)


def _crc_table() -> np.ndarray:
    table = np.zeros(256, np.int64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0xA001 if c & 1 else c >> 1
        table[i] = c
    return table


CRC_TABLE = _crc_table()


def crc16(payload: torch.Tensor) -> torch.Tensor:
    """CRC16 (poly 0xA001 reflected, init 0xFFFF) of each row [B, nbytes]."""
    table = torch.as_tensor(CRC_TABLE, device=payload.device)
    crc = torch.full((payload.shape[0],), 0xFFFF, dtype=torch.int64,
                     device=payload.device)
    for k in range(payload.shape[1]):
        crc = (crc >> 8) ^ table[(crc ^ payload[:, k].long()) & 0xFF]
    return crc


@dataclass
class Mode:
    """The tables one OFDM mode's transmitter needs (host numpy)."""
    points: int
    nsymb: int
    preamble_nsymb: int
    frame_bytes: int
    n_real: int
    n_virtual: int
    k: int
    gen: np.ndarray            # [P, K] uint8 parity generator
    dispersal: np.ndarray
    bit_perm: np.ndarray
    tf_perm: np.ndarray
    data_cells: np.ndarray
    pilot_cells: np.ndarray
    pilot_seq: np.ndarray
    preamble: np.ndarray       # [preamble_nsymb, Nc], pre-equalized
    pre_eq: np.ndarray
    const: np.ndarray
    fir_tx1: np.ndarray
    fir_tx2: np.ndarray

    @property
    def sym_len(self) -> int:
        return (NFFT + NGI) * INTERP

    @property
    def frame_len(self) -> int:
        return self.sym_len * (self.nsymb + self.preamble_nsymb)


def _pilot_types(nsymb: int, dy: int) -> np.ndarray:
    """Pilot lattice of ofdm.cc:976-1064 (Dx 1); the last column copies
    the first when it holds fewer than two pilots."""
    size = max(NC, nsymb)
    grid = np.full((size, size), DATA, np.int8)
    for x in range(size):
        grid[x % dy::dy, x] = PILOT
    if int(np.sum(grid[:nsymb, NC - 1] == PILOT)) < 2:
        grid[:, NC - 1] = grid[:, 0]
    return grid[:nsymb, :NC]


def _pre_eq(bits: np.ndarray, mlog2: int, const: np.ndarray,
            fir_tx1: np.ndarray, fir_tx2: np.ndarray) -> np.ndarray:
    """Mean of sent / received carriers over the PRNG's probe symbols
    through the TX FIRs and the receiver's data FIR
    (telecom_system.cc:3108-3145), all probe symbols at once."""
    fir_rx = design_fir(FS, 3000, BANDWIDTH / 2, "lpf", "hamming")
    idx = bits.reshape(-1, NC, mlog2) @ (1 << np.arange(mlog2)[::-1])
    syms = torch.as_tensor(const[idx])
    td = _ofdm_mod(syms[:, None, :], torch.as_tensor(pad_map()))
    pb = _mix_up(_interp(td, INTERP))
    f2 = _fir_same(_fir_same(pb, torch.as_tensor(fir_tx1)),
                   torch.as_tensor(fir_tx2))
    ph = (2 * math.pi * FC / FS) * torch.arange(pb.shape[-1],
                                                dtype=torch.float64)
    iq = f2 * math.sqrt(2.0) * torch.exp(1j * ph)
    bb = _fir_same(iq, torch.as_tensor(fir_rx))[:, ::INTERP]
    spec = torch.fft.fft(bb[:, NGI:NGI + NFFT], dim=-1) / NFFT
    rx = spec[:, torch.as_tensor(pad_map())]
    return (syms / rx).mean(0).numpy()


def build_mode(cfg: dict) -> Mode:
    """A configuration file's mode -> the transmitter's tables."""
    m = int(cfg["constellation_points"])
    mlog2 = m.bit_length() - 1
    density = cfg["pilot_density"]
    nsymb, dy = NSYMB[density][m], DY[density][m]
    pre_nsymb = int(cfg["preamble_nsymb"])
    flat = _pilot_types(nsymb, dy).ravel()
    pilot_cells = np.nonzero(flat == PILOT)[0]
    data_cells = np.nonzero(flat == DATA)[0]
    n_data = len(data_cells)
    n_bits = n_data * mlog2
    k = N_LDPC * int(cfg["ldpc_rate_num"]) // 16
    n_real = n_bits - (N_LDPC - k)
    # preamble: QPSK on the even FFT bins; the imaginary part draws first
    pmap = pad_map()
    pre_cells = np.nonzero(np.tile(pmap % 2 == 0, pre_nsymb))[0]
    draws = glibc_random_bits(PREAMBLE_SEED, 2 * pre_nsymb * NC).reshape(-1, 2)
    seq = ((2 * draws[:, 1] - 1) + 1j * (2 * draws[:, 0] - 1)) / math.sqrt(2)
    preamble = np.zeros(pre_nsymb * NC, np.complex128)
    preamble[pre_cells] = seq[:len(pre_cells)]
    # pilots: a DBPSK walk (ofdm.cc:940-952); the pre-equalization probe
    # continues the same generator
    n_pil = len(pilot_cells)
    raw = glibc_random_bits(PILOT_SEED, n_pil + 1000 * NC * mlog2)
    walk = np.bitwise_xor.accumulate(raw[:n_pil])
    pilot_seq = (2.0 * walk - 1.0) * np.float64(np.float32(PILOT_BOOST))
    const = constellation(m)
    fir_tx1 = design_fir(FS, 1000, FC - BANDWIDTH / 2, "hpf", "hamming")
    fir_tx2 = design_fir(FS, 1000, FC + BANDWIDTH / 2, "lpf", "blackman")
    pre_eq = _pre_eq(raw[n_pil:], mlog2, const, fir_tx1, fir_tx2)
    code = np.load(LDPC_TABLES)
    tag = f"{int(cfg['ldpc_rate_num'])}_16"
    assert int(code[f"{tag}_K"]) == k
    return Mode(
        points=m, nsymb=nsymb, preamble_nsymb=pre_nsymb,
        frame_bytes=(n_real - 16) // 8, n_real=n_real,
        n_virtual=N_LDPC - n_bits, k=k, gen=code[f"{tag}_G"],
        dispersal=glibc_random_bits(DISPERSAL_SEED, N_LDPC)[:n_real],
        bit_perm=interleaver_perm(n_bits, n_bits // 10),
        tf_perm=interleaver_perm(n_data, n_data // 10),
        data_cells=data_cells, pilot_cells=pilot_cells, pilot_seq=pilot_seq,
        preamble=preamble.reshape(pre_nsymb, NC) * pre_eq[None],
        pre_eq=pre_eq, const=const, fir_tx1=fir_tx1, fir_tx2=fir_tx2)


@torch.no_grad()
def transmit(mode: Mode, payload: torch.Tensor) -> torch.Tensor:
    """payload [B, frame_bytes] uint8 -> passband frames [B, frame_len]
    float32, on payload's device."""
    dev = payload.device
    t = lambda a: torch.as_tensor(a, device=dev)          # noqa: E731
    b = payload.shape[0]
    bits = ((payload.long()[..., None] >> torch.arange(8, device=dev)) & 1
            ).reshape(b, -1)
    crc = crc16(payload)
    crc_bits = (crc[:, None] >> torch.arange(16, device=dev)) & 1
    waste = mode.n_real - mode.frame_bytes * 8 - 16
    real = torch.cat([bits, crc_bits,
                      torch.zeros((b, waste), dtype=torch.long, device=dev)], -1)
    disp = real ^ t(mode.dispersal)
    u = torch.cat([disp, disp[:, :mode.n_virtual]], -1)
    parity = (u.double() @ t(mode.gen).double().T).remainder(2).long()
    tx_bits = torch.cat([disp, parity], -1)[:, t(mode.bit_perm)]
    mlog2 = mode.points.bit_length() - 1
    idx = (tx_bits.reshape(b, -1, mlog2)
           * (1 << torch.arange(mlog2 - 1, -1, -1, device=dev))).sum(-1)
    syms = t(mode.const)[idx][:, t(mode.tf_perm)]
    grid = torch.zeros((b, mode.nsymb * NC), dtype=torch.complex128,
                       device=dev)
    grid[:, t(mode.data_cells)] = syms
    grid[:, t(mode.pilot_cells)] = t(mode.pilot_seq).to(torch.complex128)
    grid = grid.reshape(b, mode.nsymb, NC) * t(mode.pre_eq)
    pmap = t(pad_map())
    norm = math.sqrt(NFFT * INTERP)
    pre = _ofdm_mod(t(mode.preamble).expand(b, -1, -1), pmap) * (AMP_PRE / norm)
    dat = _ofdm_mod(grid, pmap) * (AMP_DATA / norm)
    n_pre = pre.shape[-1] * INTERP
    pb = _mix_up(torch.cat([_interp(pre, INTERP), _interp(dat, INTERP)], -1))
    pb = torch.cat([_clip(pb[:, :n_pre], PAPR_PRE_DB),
                    _clip(pb[:, n_pre:], PAPR_DATA_DB)], -1)
    out = _fir_same(_fir_same(pb, t(mode.fir_tx1)), t(mode.fir_tx2))
    return out.float()


def sigma_for_esn0(esn0_db: float) -> float:
    """Per-real-sample noise std at Es/N0 (passband_test_EsN0)."""
    return 10 ** (-esn0_db / 20.0) / math.sqrt(2.0)
