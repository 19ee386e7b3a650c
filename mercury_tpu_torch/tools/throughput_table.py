"""Per-mode receive throughput table and batch-size sweep on one CUDA card
(the port's counterpart of the repo root's tools/throughput_table.py).

    python -m mercury_tpu_torch.tools.throughput_table [--quick] [--cpu]
        [--out FILE.json]

Full receive (mixer + FIR, sync, channel estimate, equalize, demap, LDPC,
CRC) throughput for every mode: the 17 OFDM configs and the 3 MFSK ROBUST
modes, CONFIG_0 again with deep sync off, and (unless --quick) a batch
sweep at CONFIG_9. Prints a markdown table to stdout; --out also writes the
rows as JSON (no default: the JAX tool's record stays its own). Without a
card and without --cpu it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from mercury_tpu_torch.bench import sync
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.convert import cli_device, describe, resolve_device
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain

MODES = list(range(17)) + [100, 101, 102]   # every OFDM + MFSK mode
BATCH = 256
REPS = 10
BATCH_SWEEP = [1, 4, 16, 64, 256, 512]
ESN0_DB = 30.0
NAME = {100: "ROBUST_0", 101: "ROBUST_1", 102: "ROBUST_2"}


def measure(config: int, batch: int, reps: int,
            deep_sync: bool | None = None, device=None) -> dict:
    """One mode's row: the JAX tool's capture (payload
    np.random.default_rng(0) bytes, Es/N0 30 dB at its delay for every
    mode; the noise from a torch generator seeded 1), a first receive
    (first_call_s: caches and plans, nothing compiled), then reps receives
    of the same buffer ending in a synchronize."""
    device = resolve_device(device)
    g = build_geometry(config)
    tx, rx = TxChain(g, device=device), RxChain(g, device=device,
                                                deep_sync=deep_sync)
    payload = np.random.default_rng(0).integers(
        0, 256, (batch, g.frame_bytes)).astype(np.uint8)
    frames = tx.transmit(torch.from_numpy(payload).to(device))
    buf_len = g.nofdm * g.buffer_nsymb * g.interp
    delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
    # 30 dB: above every mode's waterfall once the ~5 dB passband to
    # per-carrier offset is taken out; at 20 dB CONFIG_16 cannot decode and
    # its LDPC runs to the iteration cap, understating throughput ~4x
    gen = torch.Generator(device=device).manual_seed(1)
    buf = sim.awgn_passband(frames, sim.sigma_for_esn0(ESN0_DB), delay,
                            buf_len, gen)

    t0 = time.perf_counter()
    res = rx.receive(buf)
    sync(device)
    first_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(reps):
        res = rx.receive(buf)
    sync(device)
    dt = time.perf_counter() - t0

    ok = res.crc_ok.cpu().numpy()
    sps = batch * buf_len * reps / dt
    # payload goodput: decoded payload bits per wall second; the real-time
    # channel consumes 48000 samples/s, so the card keeps up with
    # sps / 48000 channels
    return {
        "config": config,
        "deep_sync": rx.deep_sync,
        "batch": batch,
        "buf_len": buf_len,
        "frame_bytes": g.frame_bytes,
        "msamples_per_s": sps / 1e6,
        "decode_goodput_mbit_s": int(ok.sum()) * g.frame_bytes * 8 * reps
        / dt / 1e6,
        "realtime_channels": int(sps / 48000),
        "crc_ok_frac": float(ok.mean()),
        "ms_per_call": dt / reps * 1e3,
        "first_call_s": first_s,
    }


def table(device, reps: int, sweep: bool = True, batch: int = BATCH,
          log=lambda m: print(m, file=sys.stderr)) -> dict:
    """Every mode at `batch`, CONFIG_0 with deep sync off, and the batch
    sweep at CONFIG_9 if `sweep` -> {"meta", "per_mode", "batch_sweep"}."""
    device = resolve_device(device)
    rows = []
    for cfg in MODES:
        r = measure(cfg, batch, reps, device=device)
        rows.append(r)
        log(f"  cfg{cfg}: {r['msamples_per_s']:.1f} Ms/s "
            f"({r['realtime_channels']} rt-channels, crc {r['crc_ok_frac']})")
    # deep sync (on by default below CONFIG_5) buys acquisition margin for
    # front-end work; a high-SNR batched deployment can turn it off
    r = measure(0, batch, reps, deep_sync=False, device=device)
    rows.append(r)
    log(f"  cfg0 (deep off): {r['msamples_per_s']:.1f} Ms/s")
    swept = []
    for b in (BATCH_SWEEP if sweep else []):
        r = measure(9, b, reps, device=device)
        swept.append(r)
        log(f"  batch {b}: {r['msamples_per_s']:.1f} Ms/s "
            f"({r['ms_per_call']:.3f} ms/call)")
    return {"meta": {**describe(device), "reps": reps, "esn0_db": ESN0_DB,
                     "batch": batch},
            "per_mode": rows, "batch_sweep": swept}


def markdown(out: dict) -> str:
    lines = ["| config | Msamples/s | goodput Mbit/s | realtime channels "
             "| ms/call | crc ok |", "|---|---:|---:|---:|---:|---:|"]
    for r in out["per_mode"]:
        label = NAME.get(r["config"], f"CONFIG_{r['config']}")
        if r["config"] <= 4 and not r["deep_sync"]:
            label += " (deep_sync=off)"
        lines.append(f"| {label} | {r['msamples_per_s']:.1f} "
                     f"| {r['decode_goodput_mbit_s']:.1f} "
                     f"| {r['realtime_channels']} | {r['ms_per_call']:.3f} "
                     f"| {r['crc_ok_frac']} |")
    if out["batch_sweep"]:
        lines += ["", "| batch | Msamples/s | ms/call |", "|---:|---:|---:|"]
        lines += [f"| {r['batch']} | {r['msamples_per_s']:.1f} "
                  f"| {r['ms_per_call']:.3f} |" for r in out["batch_sweep"]]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mercury_tpu_torch.tools."
                                 "throughput_table", description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="3 reps, skip the batch sweep")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = cli_device(args.cpu)
    if device is None:
        return 1
    out = table(device, 3 if args.quick else REPS, sweep=not args.quick)
    print(markdown(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"\nwrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
