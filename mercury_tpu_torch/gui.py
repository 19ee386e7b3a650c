"""Graphical monitor: the visual counterpart of the terminal dashboard.

The reference ships an ImGui/GLFW window (gui_main.cc:452-1124) with a jet
waterfall (waterfall.cc:106-254), constellation scatter, VU meters and
readout text. This is its TPU-repo counterpart on matplotlib: the same
panels composed into one figure, usable three ways —

  * live window:      VisualMonitor().show() then .update(...) per chunk
  * headless snapshot: .snapshot("monitor.png") (Agg backend, CI-safe)
  * CLI:              python -m mercury_tpu -m MONITOR -i cap.f32 --gui

The runtime *controls* (gain sliders, LDPC iterations, config switch,
tune button) live on the TCP control surface (`link/tcp_api.py`:
TXGAIN/RXGAIN/LDPCITER/SETCONFIG/TUNE/GEARSHIFT) — any client, including
a notebook, can drive them while watching this monitor; the reference
binds the same knobs to its ImGui widgets.
"""

from __future__ import annotations

import numpy as np


class VisualMonitor:
    def __init__(self, width_s: float = 8.0, fs: float = 48000.0,
                 interactive: bool = False):
        import matplotlib

        if not interactive:
            matplotlib.use("Agg", force=True)
        import matplotlib.pyplot as plt

        self._plt = plt
        self.fs = fs
        self._spec = np.zeros((0, 257))
        self._levels: list[float] = []
        self.fig = plt.figure(figsize=(9, 7), layout="constrained")
        gs = self.fig.add_gridspec(3, 2, height_ratios=[3, 2, 0.6])
        self.ax_wf = self.fig.add_subplot(gs[0, :])
        self.ax_const = self.fig.add_subplot(gs[1, 0])
        self.ax_vu = self.fig.add_subplot(gs[1, 1])
        self.ax_txt = self.fig.add_subplot(gs[2, :])
        self.ax_txt.axis("off")
        self._im = None
        self._txt = self.ax_txt.text(0.01, 0.5, "", family="monospace",
                                     fontsize=10, va="center")
        self.fig.suptitle("mercury-tpu monitor")

    def update(self, samples: np.ndarray | None = None,
               constellation: np.ndarray | None = None,
               state: dict | None = None) -> None:
        """Feed capture samples (waterfall + VU), equalized data symbols
        (constellation) and readout state (same keys as Dashboard.frame)."""
        from mercury_tpu_torch.dashboard import level_dbfs
        from mercury_tpu_torch.obs import waterfall

        if samples is not None and len(samples):
            spec, freqs = waterfall(np.asarray(samples, np.float32), self.fs)
            if len(spec):
                self._spec = (np.concatenate([self._spec, spec])[-240:]
                              if self._spec.size else spec)
            self._levels = (self._levels + [level_dbfs(samples)])[-60:]
            self._freqs = freqs

        if self._spec.size:
            lo = np.percentile(self._spec, 5)
            hi = np.percentile(self._spec, 99.5)
            img = np.clip((self._spec - lo) / max(hi - lo, 1e-6), 0, 1)
            if self._im is None:
                self._im = self.ax_wf.imshow(
                    img.T, aspect="auto", origin="lower", cmap="jet",
                    extent=[0, img.shape[0], 0, self.fs / 2 / 1e3])
                self.ax_wf.set_ylabel("kHz")
                self.ax_wf.set_xlabel("time (symbols)")
                self.ax_wf.set_ylim(0, 3.5)     # HF channel region
            else:
                self._im.set_data(img.T)
                self._im.set_extent([0, img.shape[0], 0, self.fs / 2 / 1e3])

        self.ax_const.cla()
        self.ax_const.set_title("constellation", fontsize=9)
        self.ax_const.set_xlim(-2, 2)
        self.ax_const.set_ylim(-2, 2)
        self.ax_const.axhline(0, lw=0.3, color="gray")
        self.ax_const.axvline(0, lw=0.3, color="gray")
        if constellation is not None and len(np.atleast_1d(constellation)):
            c = np.asarray(constellation).ravel()
            self.ax_const.plot(c.real, c.imag, ".", ms=2, alpha=0.6)

        self.ax_vu.cla()
        self.ax_vu.set_title("RX level (dBFS)", fontsize=9)
        self.ax_vu.set_ylim(-60, 0)
        if self._levels:
            self.ax_vu.bar(range(len(self._levels)), self._levels,
                           width=1.0, bottom=0)
            self.ax_vu.set_ylim(-60, 0)

        s = state or {}
        self._txt.set_text(
            f"cfg={s.get('config', '-')}  link={s.get('link_status', '-')}  "
            f"SNR {s.get('snr_db', float('nan')):.1f} dB  "
            f"CFO {s.get('cfo_hz', float('nan')):+.2f} Hz  "
            f"SIG {s.get('signal_dbm', float('nan')):.1f} dBm  "
            f"noise {s.get('noise_floor_dbm') if s.get('noise_floor_dbm') is not None else float('nan'):.1f} dBm")

    def snapshot(self, path: str) -> None:
        self.fig.savefig(path, dpi=100)

    def show(self, block: bool = False) -> None:
        self._plt.ion()
        self.fig.show()

    def pump(self) -> None:
        """Process GUI events after update() in live mode."""
        self.fig.canvas.draw_idle()
        self.fig.canvas.flush_events()

    def close(self) -> None:
        self._plt.close(self.fig)
