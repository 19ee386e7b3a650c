"""ARQ link benchmark of the port: effective throughput against channel SNR
(the counterpart of the repo root's tools/link_benchmark.py).

    python -m mercury_tpu_torch.tools.link_benchmark MODE [flags], e.g.
        sweep --config 9 --snrs 5,10,15
        adaptive --snrs 0,10,20,30
        stress --bytes 4000 --burst-snr -5

Two ArqNodes (their PHY chains on the CUDA card, or on the CPU with --cpu)
over the deterministic simulated channel (link/sim.py), so a sweep runs in
minutes instead of hours of wall-clock audio; the measurement is delivered
bytes over the simulated session time. sweep: fixed config; adaptive:
gearshift on; stress: random noise bursts to --burst-snr against the
gearshift/BREAK machinery, with a timeline of (simulated time, SNR, config,
delivered bytes). --chart renders that timeline as a PNG and needs
matplotlib, which the card's machine does not have (it raises there).
Without a card and without --cpu it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from mercury_tpu_torch.convert import cli_device
from mercury_tpu_torch.link import protocol as P
from mercury_tpu_torch.link.node import ArqConfig, ArqNode
from mercury_tpu_torch.link.sim import ChannelModel, LinkSimulator


def run_session(init_cfg, snr_db, n_bytes, gear, robust, seed=0,
                max_sim_s=3600, fading=None, profile="static",
                device=None) -> dict:
    """One transfer of n_bytes (default_rng(seed) bytes) from a commander
    to a responder at snr_db -> the JAX tool's result keys."""
    cfg = ArqConfig(init_configuration=init_cfg, gear_shift_on=gear,
                    robust_enabled=robust, rx_profile=profile)
    cmd = ArqNode("VE3TPU", P.COMMANDER, cfg, device=device)
    rsp = ArqNode("N0CALL", P.RESPONDER, cfg, device=device)
    sim = LinkSimulator(cmd, rsp, ChannelModel(snr_db=snr_db, seed=seed,
                                               fading=fading))
    payload = bytes(np.random.default_rng(seed).integers(0, 256, n_bytes)
                    .astype(np.uint8))
    cmd.send_data(payload)
    cmd.connect("N0CALL")
    t = sim.run(max_sim_s=max_sim_s,
                until=lambda: len(rsp.fifo_rx) >= n_bytes)
    got = rsp.received()
    return {
        "snr_db": snr_db,
        "delivered": len(got),
        "intact": got == payload,
        "sim_seconds": round(t, 1),
        "bytes_per_min": round(len(got) * 60.0 / max(t, 1e-9), 1),
        "bps": round(len(got) * 8.0 / max(t, 1e-9), 1),
        "final_config": cmd.current_configuration,
        "breaks": cmd.stats.breaks_sent,
        "gearshift_ups": cmd.stats.gearshift_ups,
    }


def run_stress(init_cfg, n_bytes, base_snr, burst_snr, seed=0,
               max_sim_s=3600, tick_s=5.0, device=None):
    """Noise-burst resilience run: random SNR bursts while a transfer is in
    flight, gearshift + BREAK enabled. Returns (summary, timeline)."""
    rng = np.random.default_rng(seed)
    # the burst windows, drawn up front (the reference stress: random
    # on/off)
    bursts, t = [], 0.0
    while t < max_sim_s:
        t += float(rng.uniform(20.0, 60.0))          # quiet gap
        dur = float(rng.uniform(8.0, 25.0))          # burst duration
        bursts.append((t, t + dur))
        t += dur

    def snr_at(now_s):
        for a, b in bursts:
            if a <= now_s < b:
                return burst_snr
        return base_snr

    cfg = ArqConfig(init_configuration=init_cfg, gear_shift_on=True,
                    robust_enabled=True)
    cmd = ArqNode("VE3TPU", P.COMMANDER, cfg, device=device)
    rsp = ArqNode("N0CALL", P.RESPONDER, cfg, device=device)
    sim = LinkSimulator(cmd, rsp,
                        ChannelModel(seed=seed, snr_schedule=snr_at))
    payload = bytes(rng.integers(0, 256, n_bytes).astype(np.uint8))
    cmd.send_data(payload)
    cmd.connect("N0CALL")

    timeline, elapsed = [], 0.0
    while elapsed < max_sim_s and len(rsp.fifo_rx) < n_bytes:
        elapsed += sim.run(max_sim_s=tick_s,
                           until=lambda: len(rsp.fifo_rx) >= n_bytes)
        timeline.append({
            "t_s": round(elapsed, 1),
            "snr_db": snr_at(elapsed),
            "config": cmd.current_configuration,
            "delivered": len(rsp.fifo_rx),
            "breaks": cmd.stats.breaks_sent,
        })
        if cmd.link_status == P.DROPPED or rsp.link_status == P.DROPPED:
            break
    got = rsp.received()
    summary = {
        "delivered": len(got),
        "intact": got == payload,
        "sim_seconds": round(elapsed, 1),
        "bytes_per_min": round(len(got) * 60.0 / max(elapsed, 1e-9), 1),
        "final_config": cmd.current_configuration,
        "breaks": cmd.stats.breaks_sent,
        "gearshift_ups": cmd.stats.gearshift_ups,
        "gearshift_downs": cmd.stats.gearshift_downs,
        "bursts": [[round(a, 1), round(b, 1)] for a, b in bursts
                   if a < elapsed],
    }
    return summary, timeline


def stress_chart(timeline, bursts, path):
    """The stress timeline as a PNG (matplotlib, imported here: the card's
    machine has none, and there this raises ImportError)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ts = [p["t_s"] for p in timeline]
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(12, 6), sharex=True)
    ax1.step(ts, [p["config"] for p in timeline], where="post",
             label="config")
    for a, b in bursts:
        ax1.axvspan(a, b, alpha=0.2, color="red")
        ax2.axvspan(a, b, alpha=0.2, color="red")
    ax1.set_ylabel("config")
    ax1.legend(loc="upper left")
    ax2.plot(ts, [p["delivered"] for p in timeline], label="delivered bytes")
    ax2.set_xlabel("simulated seconds")
    ax2.set_ylabel("bytes")
    ax2.legend(loc="upper left")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    print(f"wrote {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mercury_tpu_torch.tools."
                                 "link_benchmark", description=__doc__)
    ap.add_argument("mode", choices=["sweep", "adaptive", "stress"])
    ap.add_argument("--config", type=int, default=0)
    ap.add_argument("--snrs", default="0,5,10,15,20,25,30")
    ap.add_argument("--bytes", type=int, default=2000)
    ap.add_argument("--robust", action="store_true")
    ap.add_argument("--base-snr", type=float, default=15.0)
    ap.add_argument("--burst-snr", type=float, default=-5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chart", default=None,
                    help="stress: write the timeline as a PNG (needs "
                    "matplotlib; the card's machine has none)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--fading", default=None,
                    choices=["good", "moderate", "poor"],
                    help="continuous Watterson fading (CCIR preset) on top "
                    "of the AWGN; pairs with --profile track")
    ap.add_argument("--profile", default="static",
                    choices=["static", "track"],
                    help="receiver profile (track = decision-directed "
                    "fading tracking)")
    args = ap.parse_args(argv)
    device = cli_device(args.cpu)
    if device is None:
        return 1

    if args.mode == "stress":
        summary, timeline = run_stress(args.config, args.bytes,
                                       args.base_snr, args.burst_snr,
                                       seed=args.seed, device=device)
        print(json.dumps(summary, indent=1))
        if args.chart:
            stress_chart(timeline, summary["bursts"], args.chart)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"summary": summary, "timeline": timeline}, f,
                          indent=1)
            print(f"wrote {args.out}")
        return 0

    snrs = [float(s) for s in args.snrs.split(",")]
    gear = args.mode == "adaptive"
    results = []
    for snr in snrs:
        r = run_session(args.config, snr, args.bytes, gear, args.robust,
                        seed=int(snr * 10) & 0xFF, fading=args.fading,
                        profile=args.profile, device=device)
        results.append(r)
        print(f"SNR {snr:+.0f} dB: {r['bytes_per_min']} B/min "
              f"({r['bps']} bps), final cfg {r['final_config']}, "
              f"{'OK' if r['intact'] else 'INCOMPLETE'} in "
              f"{r['sim_seconds']}s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
