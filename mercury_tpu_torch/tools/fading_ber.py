"""FER under the Watterson HF fading channel (CCIR 520 presets) with the
port's chains (the counterpart of the repo root's tools/fading_ber.py).

The reference's Monte-Carlo harness is AWGN-only (awgn.cc); real HF paths
fade. This sweeps channel SNR for a ladder cross-section under
good/moderate/poor Watterson conditions (channel/sim.py watterson: two
Rayleigh paths, Gaussian Doppler). The fading is made on the host (numpy,
the same arithmetic and seeds as the JAX tool, so both fade the same
frames); the AWGN comes from a seeded torch.Generator on the device (the
JAX tool's jax.random noise cannot be drawn in torch: same power, other
noise); the receive runs batched on the CUDA card unless --cpu is given.
Without a card and without --cpu it exits 1.

    python -m mercury_tpu_torch.tools.fading_ber --out docs/fading_h100.json \\
        [--frames 256] [--configs 0 4 9 100] [--profile static|track]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.convert import card_meta, cli_device
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain

SNR_GRID = {                       # channel SNR (dB) points per config
    0: (-6, -3, 0, 3, 6),
    4: (0, 3, 6, 9, 12),
    9: (6, 9, 12, 15, 18),
    100: (-12, -9, -6, -3, 0),
}


def chains(cfg: int, profile: str, device):
    """(geometry, TxChain, RxChain) of a receiver profile: "static" = the
    default receiver (frame-wide pilot LS); "track" = the fading profile,
    a time-localized pilot LS window (5, 21) bootstrapping a
    decision-directed re-estimation with a (5, 9) window, 2 passes. MFSK
    modes are noncoherent: the profile is ignored."""
    if profile == "track" and not build_geometry(cfg).spec.is_mfsk:
        g = build_geometry(cfg, ls_window=(5, 21))
        return (g, TxChain(g, device=device),
                RxChain(g, device=device, dd=True, dd_window=(5, 9),
                        dd_passes=2))
    g = build_geometry(cfg)
    return g, TxChain(g, device=device), RxChain(g, device=device)


def faded_round(tx: TxChain, g, rng: np.random.Generator, batch: int,
                preset: str):
    """One round's frames, as the JAX tool draws them from rng: payloads
    [batch, frame_bytes] uint8, the transmitted passband (float64 numpy)
    and its Watterson-faded copy (float64 numpy)."""
    payload = rng.integers(0, 256, (batch, g.frame_bytes)).astype(np.uint8)
    pb = tx.transmit(torch.as_tensor(payload, device=tx.gen.device)
                     ).cpu().numpy().astype(np.float64)
    faded = sim.watterson(pb, fs=g.fs, seed=int(rng.integers(1 << 30)),
                          **sim.WATTERSON_PRESETS[preset])
    return payload, pb, faded


def run_config(cfg: int, preset: str, frames: int, batch: int,
               profile: str = "static", device=None,
               snrs=None) -> list[dict]:
    """FER at each channel SNR of SNR_GRID[cfg] (or `snrs`) -> [{"snr_db",
    "fer", "frames"}]; a frame counts when its CRC passes and its bytes are
    the payload's."""
    g, tx, rx = chains(cfg, profile, device)
    buf_len = g.nofdm * g.buffer_nsymb * g.interp
    delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
    pts = []
    for snr in (SNR_GRID[cfg] if snrs is None else snrs):
        errs = tot = 0
        rng = np.random.default_rng(100000 + 1000 * cfg + int(snr) * 7)
        for r in range(max(1, frames // batch)):
            payload, pb, faded = faded_round(tx, g, rng, batch, preset)
            sigma = sim.sigma_for_channel_snr(pb[0], float(snr), g.fs,
                                              g.bandwidth)
            gen = torch.Generator(device=rx.device).manual_seed(r + 17)
            buf = sim.awgn_passband(
                torch.as_tensor(faded, dtype=torch.float32,
                                device=rx.device),
                sigma, delay, buf_len, gen)
            res = rx.receive(buf)
            ok = res.crc_ok.cpu().numpy()
            good = ok & (res.payload.cpu().numpy() == payload).all(axis=-1)
            errs += int((~good).sum())
            tot += batch
        pts.append({"snr_db": float(snr), "fer": round(errs / tot, 4),
                    "frames": tot})
        print(f"  cfg{cfg} {preset} {snr:+.0f} dB: FER {errs/tot:.3f}",
              file=sys.stderr, flush=True)
    return pts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mercury_tpu_torch.tools.fading_ber",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--configs", type=int, nargs="*",
                    default=[0, 4, 9, 100])
    ap.add_argument("--presets", nargs="*",
                    default=["good", "moderate", "poor"])
    ap.add_argument("--profile", default="static",
                    choices=["static", "track"],
                    help="receiver profile: static (default chain) or track "
                    "(time-localized LS + decision-directed re-estimation)")
    ap.add_argument("--out", required=True, help="output JSON")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = cli_device(args.cpu)
    if device is None:
        return 1
    out = {"meta": {**card_meta(device),
                    "frames_per_point": args.frames,
                    "batch": args.batch,
                    "profile": args.profile,
                    "model": "Watterson 2-path Rayleigh, CCIR 520 presets"},
           "results": []}
    for cfg in args.configs:
        for preset in args.presets:
            pts = run_config(cfg, preset, args.frames, args.batch,
                             args.profile, device)
            out["results"].append({"config": cfg, "preset": preset,
                                   "points": pts})
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
