"""Observability: metrics registry and RX diagnostics arrays (PyTorch port
of the JAX package's `obs.py`; `Metrics` and `waterfall` are host numpy,
copied as they are).

Replaces the reference's printf tracing and ImGui visual feeds
([OFDM-SYNC]/[CHAN-EST]/[GEARSHIFT] logs, waterfall/constellation GUI taps)
with structured counters/timers and notebook-friendly arrays.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import torch


class Metrics:
    """Process-wide counters, gauges, and stage timers."""

    def __init__(self):
        self.counters: dict[str, int] = defaultdict(int)
        self.gauges: dict[str, float] = {}
        self.timings: dict[str, list[float]] = defaultdict(list)

    def count(self, name: str, inc: int = 1) -> None:
        self.counters[name] += inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name].append(time.perf_counter() - t0)

    def report(self) -> str:
        lines = ["== counters =="]
        for k in sorted(self.counters):
            lines.append(f"  {k}: {self.counters[k]}")
        lines.append("== gauges ==")
        for k in sorted(self.gauges):
            lines.append(f"  {k}: {self.gauges[k]:.4g}")
        lines.append("== timings (ms: mean / p50 / max / n) ==")
        for k in sorted(self.timings):
            t = np.array(self.timings[k]) * 1000
            lines.append(f"  {k}: {t.mean():.2f} / {np.median(t):.2f} / "
                         f"{t.max():.2f} / {len(t)}")
        return "\n".join(lines)


METRICS = Metrics()


def waterfall(samples: np.ndarray, fs: float = 48000.0, nfft: int = 512,
              hop: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Spectrogram array (dB) for waterfall display (reference:
    gui/waterfall.cc 512-pt FFT feed). Returns (spec [frames, nfft//2+1],
    freqs)."""
    samples = np.asarray(samples, dtype=np.float64)
    n_frames = max((len(samples) - nfft) // hop + 1, 0)
    win = np.hanning(nfft)
    rows = np.empty((n_frames, nfft // 2 + 1))
    for i in range(n_frames):
        seg = samples[i * hop: i * hop + nfft] * win
        rows[i] = 20 * np.log10(np.abs(np.fft.rfft(seg)) + 1e-12)
    return rows, np.fft.rfftfreq(nfft, 1 / fs)


def rx_diagnostics(rx_chain, pb_buffer: np.ndarray) -> dict:
    """One-shot RX diagnostics for notebooks, on rx_chain's device: the
    Schmidl-Cox metric curve of the TS-FIR baseband (OFDM), the detected
    delay, CRC, SNR and frequency offset, the equalized constellation and
    the channel magnitude over the frame grid (OFDM) or the tone energies
    (MFSK), and the waterfall: the arrays the reference feeds its GUI.
    Every array returned is numpy on the host."""
    from mercury_tpu_torch.modem import sync as sync_mod

    g = rx_chain.geom
    buf = torch.as_tensor(np.asarray(pb_buffer, np.float32)[None],
                          device=rx_chain.device)
    out: dict = {}
    with torch.no_grad():
        if not g.spec.is_mfsk:
            bb = rx_chain.to_baseband(buf, 0.0, data_fir=False)
            met, _cfo = sync_mod.schmidl_cox_metric(bb, g)
            out["sync_metric"] = met[0].cpu().numpy()
        res = rx_chain.receive(buf)
        delay = int(res.delay[0])
        freq = float(res.freq_offset[0])
        out.update(delay=delay, crc_ok=bool(res.crc_ok[0]),
                   snr_db=float(res.snr_db[0]), freq_offset=freq)
        # equalized constellation and channel estimate
        bb_d = rx_chain.to_baseband(buf, freq, data_fir=True)
        frame = rx_chain.extract_frame(bb_d, torch.tensor([delay]))
        grid = rx_chain.demod_grid(frame)
        if not g.spec.is_mfsk:
            eq, variance, _mean_h, _vf = rx_chain.grid_stats(grid)
            out["constellation"] = eq[0, rx_chain._data_cells].cpu().numpy()
            y_pil = grid.reshape(1, -1)[:, rx_chain._pilot_cells]
            est = rx_chain._est_op
            h = torch.complex(y_pil.real @ est.T, y_pil.imag @ est.T)
            out["channel_mag"] = torch.abs(h)[0].reshape(
                g.nsymb, g.nc).cpu().numpy()
            out["pilot_variance"] = float(variance[0])
        else:
            out["tone_energy"] = (torch.abs(grid[0]) ** 2).cpu().numpy()
    out["waterfall"], out["waterfall_freqs"] = waterfall(pb_buffer)
    return out
