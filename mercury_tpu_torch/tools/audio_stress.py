"""Gearshift/BREAK stress of the ARQ link through the audio engine (the
counterpart of the repo root's tools/audio_stress_r5.py).

link_benchmark's stress and adaptive modes run over LinkSimulator's direct
delivery; this tool runs the same noise-burst scenario through the whole
audio path instead, the reference's VB-cable topology
(awgn_turboshift_test.py:50-80):

    commander --poll--> tx_transfer -> playback thread -> LoopbackDevice
      (+ scheduled AWGN burst) -> capture thread -> AudioBurstTransport
      (energy squelch segmentation) -> responder.on_samples -> RX chain

A noise burst in a window of the virtual link clock (sigma chosen so the
current data config fails while the ACK/BREAK tone patterns and the ROBUST
floor stay decodable) forces the gearshift-down / emergency-BREAK machinery
across the burst segmentation, squelch and ring. Events are logged in the
`t ROLE: event` form that analyze_link_log parses; the summary, the
timeline, the events and the analyzer's report go to --out. The session
passes when the payload arrives intact after at least one BREAK and one
gearshift down; otherwise the tool exits 1. The two nodes' chains run on
the CUDA card unless --cpu is given; without a card and without --cpu it
exits 1.

    python -m mercury_tpu_torch.tools.audio_stress --bytes 600 --burst 4 120 \\
        --out docs/audio_stress_h100.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from mercury_tpu_torch.convert import card_meta, cli_device
from mercury_tpu_torch.link import protocol as P
from mercury_tpu_torch.link.node import ArqConfig, ArqNode
from mercury_tpu_torch.runtime.audio import (AudioBurstTransport, AudioIO,
                                             LoopbackDevice)
from mercury_tpu_torch.tools import analyze_link_log as an


def stress(n_bytes: int = 120, init_config: int = 2,
           quiet_sigma: float = 2e-3, burst_sigma: float = 1.0,
           burst=(40.0, 160.0), wall_budget: float = 2400.0, device=None,
           echo=True) -> dict:
    """One session of n_bytes (default_rng(3) bytes) from a commander to a
    responder through two AudioIO engines over LoopbackDevice pairs, AWGN
    of burst_sigma in the virtual-clock window `burst` (s) and quiet_sigma
    elsewhere -> {"summary", "timeline", "events", "analyzer"}."""
    now_holder = [0.0]                     # virtual link clock (ms)
    b0, b1 = burst

    def sigma_now() -> float:
        t_s = now_holder[0] / 1000.0
        return burst_sigma if b0 <= t_s < b1 else quiet_sigma

    def make_channel(seed):
        rng = np.random.default_rng(seed)

        def f(x):
            return x + rng.normal(0.0, sigma_now(), len(x)).astype(np.float32)
        return f

    log_lines: list[str] = []

    def ev(role):
        def f(e):
            line = f"{now_holder[0]/1000.0:9.2f} {role}: {e}"
            log_lines.append(line)
            if echo:
                print(line, flush=True)
        return f

    cfg = ArqConfig(init_configuration=init_config, gear_shift_on=True,
                    robust_enabled=True, batch_size=2)
    node_a = ArqNode("VE3TPU", P.COMMANDER, cfg, on_event=ev("CMD"),
                     device=device)
    node_b = ArqNode("N0CALL", P.RESPONDER, cfg, on_event=ev("RSP"),
                     device=device)

    c1a, c1b = LoopbackDevice.pair(channel_fn=make_channel(1))
    c2a, c2b = LoopbackDevice.pair(channel_fn=make_channel(2))
    io_a = AudioIO(playback_dev=c1a, capture_dev=c2b, symbol_len=1088,
                   window_nsymb=4, block=1024, use_window=False)
    io_b = AudioIO(playback_dev=c2a, capture_dev=c1b, symbol_len=1088,
                   window_nsymb=4, block=1024, use_window=False)
    io_a.start()
    io_b.start()
    # squelch between quiet noise floor and burst RMS (the burst noise only
    # rides written blocks — the virtual cable is silent between writes, so
    # the energy segmentation stays valid even at decode-killing sigma)
    t_a = AudioBurstTransport(io_a, squelch=0.02, hang_samples=4096)
    t_b = AudioBurstTransport(io_b, squelch=0.02, hang_samples=4096)

    payload = bytes(np.random.default_rng(3).integers(0, 256, n_bytes)
                    .astype(np.uint8))
    timeline = []
    t_wall0 = time.monotonic()

    def shuttle(io_src, t_dst, node_dst, block):
        io_src.tx_transfer(block)
        t_end = time.monotonic() + 15.0
        while time.monotonic() < t_end:
            burst_samples = t_dst.capture()
            if burst_samples is not None:
                node_dst.on_samples(burst_samples, now_holder[0])
                return True
            time.sleep(0.02)
        return False

    lost = 0
    try:
        node_a.send_data(payload)
        node_a.connect("N0CALL")
        deadline = time.monotonic() + wall_budget
        while time.monotonic() < deadline:
            progressed = False
            for src, io_src, t_dst, dst in (
                    (node_a, io_a, t_b, node_b),
                    (node_b, io_b, t_a, node_a)):
                for block in src.poll(now_holder[0]):
                    airtime = 1000.0 * len(block) / 48000.0
                    now_holder[0] += airtime + 300.0
                    if not shuttle(io_src, t_dst, dst, np.asarray(block)):
                        lost += 1
                    progressed = True
                    timeline.append({
                        "t_s": round(now_holder[0] / 1000.0, 1),
                        "sigma": sigma_now(),
                        "cfg_cmd": node_a.current_configuration,
                        "delivered": len(node_b.fifo_rx),
                        "breaks": node_a.stats.breaks_sent,
                        "downs": node_a.stats.gearshift_downs,
                        "ups": node_a.stats.gearshift_ups,
                    })
            if len(node_b.fifo_rx) >= len(payload):
                break
            if not progressed:
                now_holder[0] += 200.0
    finally:
        io_a.stop()
        io_b.stop()

    got = node_b.received()
    summary = {
        "delivered": len(got), "intact": got == payload,
        "virtual_seconds": round(now_holder[0] / 1000.0, 1),
        "wall_seconds": round(time.monotonic() - t_wall0, 1),
        "burst_window_s": [b0, b1],
        "burst_sigma": burst_sigma,
        "final_config": node_a.current_configuration,
        "breaks_sent": node_a.stats.breaks_sent,
        "gearshift_downs": node_a.stats.gearshift_downs,
        "gearshift_ups": node_a.stats.gearshift_ups,
        "bursts_lost_in_transport": lost,
    }
    # the log analyzer over the captured event stream
    report = an.analyze(an.parse_lines(log_lines))
    return {"summary": summary, "timeline": timeline, "events": log_lines,
            "analyzer": report}


def passed(summary: dict) -> bool:
    """The stress passes: intact, at least one BREAK and one gearshift
    down."""
    return (summary["intact"] and summary["breaks_sent"] >= 1
            and summary["gearshift_downs"] >= 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mercury_tpu_torch.tools.audio_stress",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--bytes", type=int, default=120)
    ap.add_argument("--init-config", type=int, default=2)
    ap.add_argument("--quiet-sigma", type=float, default=2e-3)
    ap.add_argument("--burst-sigma", type=float, default=1.0,
                    help="burst AWGN sigma: kills CONFIG_2+ data frames "
                    "(in-band SNR ~ -6 dB) while BREAK/ACK tone patterns "
                    "and the ROBUST floor remain workable")
    ap.add_argument("--burst", type=float, nargs=2, default=[40.0, 160.0],
                    metavar=("T0", "T1"), help="burst window, virtual s")
    ap.add_argument("--wall-budget", type=float, default=2400.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = cli_device(args.cpu)
    if device is None:
        return 1
    out = stress(args.bytes, args.init_config, args.quiet_sigma,
                 args.burst_sigma, tuple(args.burst), args.wall_budget,
                 device)
    out = {"meta": card_meta(device), **out}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["summary"]))
    ok = passed(out["summary"])
    print("STRESS", "PASS" if ok else "INCOMPLETE")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
