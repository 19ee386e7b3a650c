"""Transmit chain: payload bytes -> passband samples (PyTorch port of
`TxChain` in the JAX package's `modem/tx.py`, every mode: the OFDM modes
CONFIG_0-16 and the MFSK ROBUST modes CONFIG_100-102, with the MFSK short
control frames of ROBUST_0/1).

CRC16 append -> energy dispersal -> virtual-bit duplication -> LDPC encode ->
parity relocation -> bit interleave -> PSK map, time/frequency interleave,
framing with pilots and pre-equalization (OFDM) or MFSK tones (ROBUST) ->
IFFT + GI -> power normalization -> x4 linear interpolation + carrier mix ->
PAPR clip -> TX FIR cascade (reference transmit_byte/transmit_bit,
telecom_system.cc:342-634).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from mercury_tpu_torch.convert import resolve_device
from mercury_tpu_torch.core import crc as crc_mod
from mercury_tpu_torch.core.geometry import ModeGeometry
from mercury_tpu_torch.dsp import ops
from mercury_tpu_torch.fec import ldpc
from mercury_tpu_torch.fec.tables import load_code
from mercury_tpu_torch.modem import mfsk, psk


class TxChain(nn.Module):
    """Per-mode TX program; call transmit() on byte batches.

    dtype is the real working type (float32, or float64 for reference
    parity); the complex type follows it. The chain lives on the CUDA card
    unless `device` names another (device="cpu" for the CPU; see
    convert.resolve_device). ctrl=True selects the MFSK short control frame
    of ROBUST_0/1: only the first ctrl_nbits interleaved bits are
    modulated (punctured LDPC), ctrl_nsymb symbols instead of Nsymb
    (reference telecom_system.cc:411-416, 2968-2994)."""

    def __init__(self, geom: ModeGeometry, dtype: torch.dtype = torch.float32,
                 device=None, ctrl: bool = False):
        super().__init__()
        g = geom
        device = resolve_device(device)
        if ctrl and not (g.spec.is_mfsk and g.spec.ctrl_nbits > 0):
            raise ValueError("ctrl frames exist only for ROBUST_0/ROBUST_1")
        self.geom = g
        self.dtype = dtype
        self.active_nsymb = g.ctrl_nsymb if ctrl else g.nsymb
        self.active_nbits = g.spec.ctrl_nbits if ctrl else g.n_bits
        self.cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
        np_c = np.complex128 if dtype == torch.float64 else np.complex64
        self.code = load_code(g.spec.ldpc_rate_num)
        a, c0 = crc_mod.crc_affine(g.frame_bytes)
        consts = {
            "crc_a": torch.as_tensor(a.astype(np.float32)),
            "crc_c0": torch.as_tensor(c0.astype(np.int64)),
            "dispersal": torch.as_tensor(g.dispersal[: g.n_real].astype(np.int64)),
            "bit_perm": torch.as_tensor(g.bit_perm.astype(np.int64)),
            "pad_map": torch.as_tensor(g.pad_map.astype(np.int64)),
            "gen": torch.as_tensor(self.code.gen.astype(np.float32)),
            "fir_tx1": torch.as_tensor(g.fir_tx1).to(dtype),
            "fir_tx2": torch.as_tensor(g.fir_tx2).to(dtype),
        }
        # power staging (telecom_system.cc:507-527)
        self.power_norm = math.sqrt(g.nfft * g.interp)
        self.amp_data = math.sqrt(0.1)
        self.amp_pre = self.amp_data * math.sqrt(2.0)
        if g.spec.is_mfsk:
            pre = mfsk.preamble_grid(g.mfsk, g.nc, g.preamble_nsymb)
            boost = math.sqrt(g.nc / g.mfsk.nstreams) * 10 ** (-2.0 / 20.0)
            self.amp_data *= boost
            self.amp_pre *= boost
        else:
            pre = (g.preamble_vals * g.pre_eq[None, :]
                   if g.pre_eq is not None else g.preamble_vals)
            consts.update({
                "tf_perm": torch.as_tensor(g.tf_perm.astype(np.int64)),
                "pilot_cells": torch.as_tensor(g.pilot_cells.astype(np.int64)),
                "data_cells": torch.as_tensor(g.data_cells.astype(np.int64)),
                "pilot_seq": torch.as_tensor(np.asarray(g.pilot_seq, np_c)),
                "const": torch.as_tensor(np.asarray(g.constellation, np_c))})
            if g.pre_eq is not None:
                consts["pre_eq"] = torch.as_tensor(np.asarray(g.pre_eq, np_c))
        consts["pre_grid"] = torch.as_tensor(np.asarray(pre, np_c))
        for name, t in consts.items():
            self.register_buffer(name, t)
        self.has_pre_eq = g.pre_eq is not None
        self.to(device)

    # ------------------------------------------------------------------
    def frame_bits(self, payload_bytes: torch.Tensor) -> torch.Tensor:
        """[B, frame_bytes] uint8 -> [B, nReal] bits: LSB-first payload bits,
        CRC16, zero fill (reference transmit_byte)."""
        g = self.geom
        shifts = torch.arange(8, device=payload_bytes.device)
        bits = ((payload_bytes.long()[..., None] >> shifts) & 1).reshape(
            payload_bytes.shape[0], -1)
        crc = torch.remainder(bits.to(torch.float32) @ self.crc_a.T, 2.0).long()
        crc = crc ^ self.crc_c0[None]
        waste = g.n_real - g.frame_bytes * 8 - 16
        zeros = torch.zeros((bits.shape[0], waste), dtype=torch.long,
                            device=bits.device)
        return torch.cat([bits, crc, zeros], dim=-1)

    def encode_bits(self, real_bits: torch.Tensor) -> torch.Tensor:
        """Dispersal + virtual duplication + LDPC + parity relocation ->
        transmitted bits [B, nBits]."""
        g = self.geom
        disp = real_bits ^ self.dispersal[None]
        u = torch.cat([disp, disp[:, : g.n_virtual]], dim=-1)
        cw = ldpc.encode(self.gen, u)
        return torch.cat([disp, cw[:, self.code.k:]], dim=-1)

    def modulate(self, tx_bits: torch.Tensor) -> torch.Tensor:
        """Transmitted bits [B, nBits] -> unfiltered passband
        [B, Nofdm*(preamble + active_nsymb)*interp]."""
        g = self.geom
        b = tx_bits.shape[0]
        inter = tx_bits[:, self.bit_perm]
        if g.spec.is_mfsk:
            grid = mfsk.mod(inter[:, : self.active_nbits], g.mfsk, g.nc,
                            self.active_nsymb, self.cdtype)
        else:
            syms = psk.mod(inter, self.const)[:, self.tf_perm]
            flat = torch.zeros((b, g.nsymb * g.nc), dtype=self.cdtype,
                               device=tx_bits.device)
            flat[:, self.data_cells] = syms
            flat[:, self.pilot_cells] = self.pilot_seq[None]
            grid = flat.reshape(b, g.nsymb, g.nc)
            if self.has_pre_eq:
                grid = grid * self.pre_eq[None, None, :]
        pre = self.pre_grid.expand(b, *self.pre_grid.shape)
        td_pre = ops.ofdm_mod(pre, self.pad_map, g.nfft, g.ngi)
        td_dat = ops.ofdm_mod(grid, self.pad_map, g.nfft, g.ngi)
        td_pre = td_pre.reshape(b, -1) * (self.amp_pre / self.power_norm)
        td_dat = td_dat.reshape(b, -1) * (self.amp_data / self.power_norm)
        # each segment is interpolated on its own (the reference calls
        # baseband_to_passband per segment), then mixed continuously
        int_pre = ops.linear_interp(td_pre, g.interp)
        int_dat = ops.linear_interp(td_dat, g.interp)
        bb = torch.cat([int_pre, int_dat], dim=-1)
        pb = ops.mix_to_passband(bb, g.fs, g.fc, math.sqrt(2.0), 0)
        n_pre = int_pre.shape[-1]
        return torch.cat([ops.peak_clip(pb[:, :n_pre], 7.0),
                          ops.peak_clip(pb[:, n_pre:], 10.0)],
                         dim=-1).to(self.dtype)

    def filter_single(self, passband: torch.Tensor) -> torch.Tensor:
        """TX FIR cascade for a standalone frame (SINGLE_MESSAGE)."""
        f1 = ops.fir_same(passband, self.fir_tx1)
        return ops.fir_same(f1, self.fir_tx2).to(self.dtype)

    @torch.no_grad()
    def transmit(self, payload_bytes: torch.Tensor,
                 filtered: bool = True) -> torch.Tensor:
        """payload bytes [B, <=frame_bytes] -> passband [B, total_frame_size]
        (a control frame is shorter). Short payloads are zero-padded to the frame size (the CRC covers the
        padded frame)."""
        g = self.geom
        payload_bytes = torch.as_tensor(payload_bytes, device=self.gen.device)
        nb = payload_bytes.shape[-1]
        if nb > g.frame_bytes:
            raise ValueError(
                f"payload is {nb} bytes but {g.spec.config} frames carry at "
                f"most {g.frame_bytes} bytes")
        if nb < g.frame_bytes:
            payload_bytes = torch.nn.functional.pad(
                payload_bytes, (0, g.frame_bytes - nb))
        pb = self.modulate(self.encode_bits(self.frame_bits(payload_bytes)))
        return self.filter_single(pb) if filtered else pb
