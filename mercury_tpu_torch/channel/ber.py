"""Monte-Carlo BER/FER harness (PyTorch port of the JAX package's
`channel/ber.py`): the reference's PLOT_BASEBAND/PLOT_PASSBAND self-test
(telecom_system.cc:96-330, 2393-2480), batched: one receive evaluates a
whole batch of independent noisy frames per SNR point.

Payloads and baseband bits come from the same numpy seeds as the JAX
harness, so both send the same bytes; the noise comes from a
`torch.Generator` on the chain's device, seeded as the JAX harness seeds its
key, so only its statistics match.

    BerHarness(9, batch=256).sweep([8.0, 7.0, 6.5, 6.0])   # on the card
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.convert import resolve_device
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.dsp import ops
from mercury_tpu_torch.fec import ldpc
from mercury_tpu_torch.modem import psk
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain


@dataclass
class BerPoint:
    esn0_db: float
    frames: int
    frame_errors: int
    bit_errors: int
    bits: int

    @property
    def fer(self) -> float:
        return self.frame_errors / max(self.frames, 1)

    @property
    def ber(self) -> float:
        return self.bit_errors / max(self.bits, 1)


@dataclass
class BerSweep:
    config: int
    points: list[BerPoint] = field(default_factory=list)

    def waterfall(self, fer_threshold: float = 0.1) -> float | None:
        """Lowest Es/N0 with FER below threshold."""
        ok = [p.esn0_db for p in self.points if p.fer < fer_threshold]
        return min(ok) if ok else None


class BerHarness:
    """Passband AWGN BER harness for one mode, on `device` (the card unless
    given). ctrl=True sweeps the MFSK punctured short control frames
    (ROBUST_0/1), whose waterfall the reference documents as unchanged from
    the data frames' (telecom_system.cc:2968-2994)."""

    def __init__(self, config: int, batch: int = 32, seed: int = 0,
                 pilot_density: int = 0, ctrl: bool = False, device=None,
                 **rx_kwargs):
        self.device = resolve_device(device)
        self.geom = build_geometry(config, pilot_density)
        self.ctrl = bool(ctrl)
        self.tx = TxChain(self.geom, device=self.device, ctrl=ctrl)
        self.rx = RxChain(self.geom, device=self.device, ctrl=ctrl,
                          **rx_kwargs)
        self.batch = batch
        self.seed = seed
        g = self.geom
        self.buf_len = g.nofdm * g.buffer_nsymb * g.interp
        # the reference harness's delay (telecom_system.cc:247-254,290);
        # MFSK sync quantizes to symbol boundaries, so its frames are placed
        # symbol-aligned
        if g.spec.is_mfsk:
            self.delay = (g.preamble_nsymb + 2) * g.nofdm * g.interp
        else:
            self.delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def run_point(self, esn0_db: float, n_frames: int | None = None,
                  fixed_delay: bool = False) -> BerPoint:
        """One passband Monte-Carlo point. fixed_delay=True bypasses time
        sync and decodes at the known frame offset (decode_at; the
        convention of the reference's MFSK passband test,
        telecom_system.cc:663-673)."""
        g = self.geom
        n_frames = n_frames or self.batch
        rng = np.random.default_rng(self.seed + hash(esn0_db) % 65536)
        gen = self._generator(int(esn0_db * 1000) & 0x7FFFFFFF)
        frame_errors = bit_errors = frames = 0
        while frames < n_frames:
            b = min(self.batch, n_frames - frames)
            payload = rng.integers(0, 256, (b, g.frame_bytes)).astype(np.uint8)
            tx_frames = self.tx.transmit(torch.as_tensor(payload,
                                                         device=self.device))
            if g.spec.is_mfsk:
                sigma = sim.sigma_for_channel_snr(tx_frames[0], esn0_db, g.fs,
                                                  g.bandwidth)
            else:
                sigma = sim.sigma_for_esn0(esn0_db)
            # fill="signal": the reference pads the pre-delay region with
            # random signal samples (awgn.cc apply_with_delay)
            buf = sim.awgn_passband(tx_frames, sigma, self.delay,
                                    self.buf_len, gen, fill="signal")
            if fixed_delay:
                got = self.rx.decode_at(
                    buf, torch.full((b,), self.delay, device=self.device),
                    0.0)[0]
            else:
                got = self.rx.receive(buf).payload
            errs = np.unpackbits(got.cpu().numpy() ^ payload,
                                 axis=-1).sum(axis=-1)
            frame_errors += int((errs > 0).sum())
            bit_errors += int(errs.sum())
            frames += b
        return BerPoint(esn0_db, frames, frame_errors, bit_errors,
                        frames * g.frame_bytes * 8)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def bb_transmit(self, bits: torch.Tensor) -> torch.Tensor:
        """The baseband step's TX half: information bits [B, nReal] (no
        CRC, no dispersal) -> LDPC codeword, bit interleave, PSK map,
        time/frequency interleave, pilots, OFDM symbols
        [B, Nsymb, Nfft+Ngi] at 1/sqrt(Nfft) power (no preamble, no
        pre-equalization)."""
        g, tx = self.geom, self.tx
        b = bits.shape[0]
        u = torch.cat([bits, bits[:, : g.n_virtual]], dim=-1)
        cw = ldpc.encode(tx.gen, u)
        tx_bits = torch.cat([bits, cw[:, tx.code.k:]], dim=-1)
        syms = psk.mod(tx_bits[:, tx.bit_perm], tx.const)[:, tx.tf_perm]
        flat = torch.zeros((b, g.nsymb * g.nc), dtype=tx.cdtype,
                           device=bits.device)
        flat[:, tx.data_cells] = syms
        flat[:, tx.pilot_cells] = tx.pilot_seq[None]
        grid = flat.reshape(b, g.nsymb, g.nc)
        return ops.ofdm_mod(grid, tx.pad_map, g.nfft, g.ngi) / math.sqrt(g.nfft)

    @torch.no_grad()
    def bb_bit_errors(self, rx_td: torch.Tensor,
                      bits: torch.Tensor) -> torch.Tensor:
        """The baseband step's decode half: received OFDM symbols rx_td
        [B, Nsymb, Nfft+Ngi] (at unit FFT power) -> carrier grid ->
        RxChain.bb_decode_bits -> bit errors against bits [B, nReal]."""
        g = self.geom
        grid = ops.ofdm_demod(rx_td, self.rx._pad_map, g.nfft, g.ngi)
        return torch.sum(self.rx.bb_decode_bits(grid) != bits, dim=-1)

    def run_point_baseband(self, esn0_db: float,
                           n_frames: int | None = None) -> BerPoint:
        """Baseband Monte-Carlo (reference baseband_test_EsN0,
        telecom_system.cc:96-229): no preamble, sync, mixers, CRC or
        dispersal; complex AWGN on the 1/sqrt(Nfft)-normalized symbols with
        sigma = 10^(-EsN0/20), the convention of the documented
        Es/N0@FER<0.1 table. Every step takes a full batch and counts its
        first `take` frames, as the JAX harness does. OFDM modes only
        (ValueError)."""
        g = self.geom
        if g.spec.is_mfsk:
            raise ValueError("baseband harness is OFDM-only (reference parity)")
        n_frames = n_frames or self.batch
        rng = np.random.default_rng(self.seed + 17)
        sigma = 10 ** (-esn0_db / 20.0)
        gen = self._generator(int(abs(esn0_db) * 977 + 13) & 0x7FFFFFFF)
        norm = math.sqrt(g.nfft)
        n_real = g.n_bits - g.ldpc_p
        frame_errors = bit_errors = frames = 0
        while frames < n_frames:
            b = self.batch
            bits = torch.as_tensor(
                rng.integers(0, 2, (b, n_real)).astype(np.int64),
                device=self.device)
            td = self.bb_transmit(bits)
            noise = torch.complex(
                torch.randn(td.shape, generator=gen, device=self.device),
                torch.randn(td.shape, generator=gen, device=self.device))
            rx_td = (td + noise * (sigma / math.sqrt(2.0))) * norm
            take = min(b, n_frames - frames)
            errs = self.bb_bit_errors(rx_td, bits)[:take].cpu().numpy()
            frame_errors += int((errs > 0).sum())
            bit_errors += int(errs.sum())
            frames += take
        return BerPoint(esn0_db, frames, frame_errors, bit_errors,
                        frames * n_real)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _mean_data_cell_power(self, x: torch.Tensor) -> float:
        """Mean data-cell power of passband rows x [B, n] through the RX
        front end at f = 0 (the data FIR kernel at start 0, FFT demod)."""
        x = self.rx._as_buffer(x)
        b = x.shape[0]
        fr = self.rx.extract_frame_decimated_pb(
            x, torch.zeros(b, dtype=torch.int64, device=self.device),
            self.rx.active_nsymb)
        grid = self.rx.demod_grid(fr).reshape(b, -1)
        cells = grid[:, self.rx._data_cells]
        return float(torch.mean(torch.abs(cells) ** 2))

    def front_end_delta(self, n_noise: int = 32) -> float:
        """The measured conversion between the passband harness's Es/N0
        parameter and the effective per-carrier Es/N0 (the baseband/table
        convention): 10*log10(S/N) at parameter 0 dB, S the mean data-cell
        power of a real TX frame after the RX front end (mix, FIR,
        decimate, FFT), N that of unit-parameter passband noise (sigma=1,
        per-sample power 1/2) through the same front end. Effective Es/N0 =
        parameter + delta (docs/esn0_reconciliation.md)."""
        g = self.geom
        rng = np.random.default_rng(self.seed + 99)
        payload = rng.integers(0, 256, (1, g.frame_bytes)).astype(np.uint8)
        pb = self.tx.transmit(torch.as_tensor(payload, device=self.device))
        pad = torch.zeros((1, pb.shape[-1] + 4 * g.nofdm * g.interp),
                          device=self.device)
        pad[:, : pb.shape[-1]] = pb
        s_pow = self._mean_data_cell_power(pad)
        noise = (1.0 / np.sqrt(2.0)) * rng.standard_normal(
            (n_noise, pad.shape[-1])).astype(np.float32)
        n_pow = self._mean_data_cell_power(torch.as_tensor(noise))
        return 10.0 * float(np.log10(s_pow / n_pow))

    def sweep(self, esn0_list, n_frames: int | None = None,
              early_exit_fer: float = 0.0, verbose: bool = False) -> BerSweep:
        """Sweep descending-difficulty points; stop early once FER reaches
        early_exit_fer (the reference's waterfall early exit)."""
        out = BerSweep(self.geom.spec.config)
        for e in esn0_list:
            p = self.run_point(e, n_frames)
            out.points.append(p)
            if verbose:
                print(f"cfg{out.config} Es/N0={e:+.1f} dB: FER={p.fer:.3f} "
                      f"BER={p.ber:.5f}")
            if p.fer <= early_exit_fer:
                break
        return out
