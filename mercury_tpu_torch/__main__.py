"""mercury-tpu CLI on PyTorch — operating modes mirroring the reference's
main.cc (the JAX package's `__main__.py`, on the port's chains).

    python -m mercury_tpu_torch -m ARQ -s 0 -p 7002   # TCP service (VARA)
    python -m mercury_tpu_torch -m BER -s 9 --esn0 12 # BER point
    python -m mercury_tpu_torch -m SWEEP -s 0         # BER sweep for a mode
    python -m mercury_tpu_torch -m TX_TEST -s 0 -o out.f32  # frame -> samples
    python -m mercury_tpu_torch -m RX_TEST -s 0 -i in.f32   # samples -> bytes
    python -m mercury_tpu_torch -m SIM                # two-node ARQ session
    python -m mercury_tpu_torch -m LIST --cpu         # mode table
    python -m mercury_tpu_torch -m BENCH              # headline benchmark

Reference CLI (main.cc:188-346): -m mode, -s config, -p tcp port, -g
gearshift, -R robust. Audio-device flags are replaced by sample-file/UDP
transports; BER/SWEEP replace PLOT_BASEBAND/PLOT_PASSBAND. Every chain,
node and harness runs on the CUDA card; --cpu runs them on the CPU (the
kernels' plain versions). Without --cpu and without a card, a mode that
builds a chain exits 1 with convert.resolve_device's message.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mercury_tpu_torch",
                                 description=__doc__)
    ap.add_argument("-m", "--mode", default="LIST",
                    choices=["ARQ", "BER", "SWEEP", "TX_TEST", "RX_TEST",
                             "SIM", "LIST", "TX_SHM", "RX_SHM",
                             "MONITOR", "BENCH"])
    ap.add_argument("--shm", default="/mercury-tpu-comm",
                    help="shared-memory ring name for TX_SHM/RX_SHM")
    ap.add_argument("-c", "--ini", default=None,
                    help="settings INI path (default: ./mercury-tpu.ini or "
                         "~/.config/mercury-tpu/mercury-tpu.ini); precedence "
                         "CLI > INI > compiled defaults, like the reference")
    ap.add_argument("--write-ini", default=None, metavar="PATH",
                    help="write the effective settings to an INI file and exit")
    ap.add_argument("-s", "--config", type=int, default=None)
    ap.add_argument("-p", "--port", type=int, default=None)
    ap.add_argument("-g", "--gearshift", type=int, default=None)
    ap.add_argument("--turbo", action="store_true", default=None,
                    help="SIM/ARQ: turboshift ladder probe after connect")
    ap.add_argument("--reverse-bytes", type=int, default=0,
                    help="SIM: after forward transfer, SWITCH_ROLE and pull "
                         "this many bytes back")
    ap.add_argument("-R", "--robust", type=int, default=None)
    ap.add_argument("-i", "--input", default=None)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--esn0", type=float, default=10.0)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--snr", type=float, default=20.0)
    ap.add_argument("--bytes", type=int, default=500)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--ldpc-algo", default="spa",
                    choices=["spa", "minsum", "layered", "layered-minsum"],
                    help="LDPC decoder: spa (full sensitivity, default), "
                    "minsum (faster check update, ~0.2-0.4 dB penalty), "
                    "layered (matmul-BP, SPA sensitivity at ~2x fewer "
                    "sweeps), layered-minsum")
    ap.add_argument("--deep-sync", default=None,
                    choices=["auto", "on", "off"],
                    help="global known-preamble acquisition (default auto: "
                    "on for CONFIG_0-4)")
    ap.add_argument("--estimator", default="auto",
                    choices=["auto", "reference"],
                    help="channel estimator: auto (ramp-aware windowed LS "
                    "everywhere, ~2 dB better at CONFIG_15/16) or reference "
                    "(the reference's per-config ZF/LS table)")
    ap.add_argument("--dd", default=None, choices=["auto", "on", "off"],
                    help="decision-directed channel re-estimation (default "
                    "auto: on for the 8PSK/QAM modes; runs only on frames "
                    "whose first LDPC pass failed)")
    ap.add_argument("--dd-window", default=None, metavar="S,C",
                    help="DD smoothing window (symbols,carriers), odd spans; "
                    "default = the pilot LS window (21,21); use a narrow "
                    "time span, e.g. 5,9, to track fading inside a frame")
    ap.add_argument("--dd-passes", type=int, default=1,
                    help="DD re-estimation iterations (default 1)")
    ap.add_argument("--wire-compat", action="store_true", default=None,
                    help="ARQ/SIM: emit stock-Mercury framing for stock "
                    "peers (INI key [ARQ] WireCompat); the receive side "
                    "accepts both framings either way")
    ap.add_argument("-r", "--radio", default=None,
                    choices=["stockhf", "sbitx"],
                    help="radio type (reference main.cc:200-218): sbitx "
                    "shifts the carrier +15 kHz; INI key [Station] RadioType")
    ap.add_argument("--gui", default=None, metavar="live|OUT.png",
                    help="MONITOR: graphical monitor (matplotlib) — 'live' "
                    "for a window, or a .png path for a headless snapshot "
                    "(the ImGui GUI's visual counterpart)")
    ap.add_argument("--rx-profile", default=None,
                    choices=["static", "track"],
                    help="ARQ/SIM receiver profile (track = fading-tracking "
                    "receiver; INI key [Modem] RxProfile)")
    args = ap.parse_args(argv)

    def _deep(a):
        return {None: None, "auto": None, "on": True, "off": False}[a.deep_sync]

    def _rx_kwargs(a):
        # ini is bound later in this scope, before any mode handler calls us
        kw = {"ldpc_algo": a.ldpc_algo, "deep_sync": _deep(a),
              "ldpc_max_iter": ini.ldpc_iterations_max,
              "cfo_range": "wide" if ini.coarse_freq_sync else "narrow"}
        kw["dd"] = {None: None, "auto": None, "on": True,
                    "off": False}[a.dd]
        if a.dd_window is not None:
            s, c = a.dd_window.split(",")
            kw["dd_window"] = (int(s), int(c))
        if a.dd_passes != 1:
            kw["dd_passes"] = a.dd_passes
        return kw

    # three config tiers, reference precedence (main.cc:354-403,547-601):
    # compiled defaults < INI file < explicit CLI flags
    from mercury_tpu_torch.core.settings import Settings
    ini = Settings.load(args.ini)
    if args.config is None:
        args.config = ini.initial_config
    if args.port is None:
        args.port = ini.control_port
    if args.gearshift is None:
        args.gearshift = int(ini.gear_shift)
    if args.robust is None:
        args.robust = int(ini.robust_mode)
    if args.turbo is None:
        args.turbo = ini.turboshift
    ini.initial_config = args.config
    ini.control_port = args.port
    ini.data_port = args.port + 1
    ini.gear_shift = bool(args.gearshift)
    ini.robust_mode = bool(args.robust)
    ini.turboshift = bool(args.turbo)
    if args.rx_profile is not None:
        ini.rx_profile = args.rx_profile
    if args.radio is not None:
        ini.radio_type = args.radio
    if args.wire_compat is not None:
        ini.wire_compat = args.wire_compat
    # radio-type carrier shift (reference main.cc:200-218): +15 kHz for sBitx
    carrier_off = 15000.0 if ini.radio_type == "sbitx" else 0.0

    if args.write_ini:
        ini.save(args.write_ini)
        print(f"wrote {args.write_ini}")
        return 0

    if args.mode == "LIST":
        from mercury_tpu_torch.core.geometry import build_geometry
        from mercury_tpu_torch.core.modes import MODES
        print(f"{'cfg':>4} {'modulation':>10} {'rate':>6} {'payload':>8} "
              f"{'frame':>8} {'net bps':>8}")
        for cfg, spec in sorted(MODES.items()):
            g = build_geometry(cfg, with_pre_eq=False)
            tf = g.nofdm * (g.nsymb + g.preamble_nsymb) / (g.fs / g.interp)
            bps = g.frame_bytes * 8 / tf
            mod = {2: "BPSK", 4: "QPSK", 8: "8PSK", 16: "16QAM", 32: "32QAM",
                   200: f"{spec.mfsk_m}-MFSK x{spec.mfsk_nstreams}"}[spec.modulation]
            print(f"{cfg:>4} {mod:>10} {spec.ldpc_rate_num:>3}/16 "
                  f"{g.frame_bytes:>6} B {tf:>7.2f}s {bps:>8.1f}")
        return 0

    # every other mode builds chains: on the card, or on the CPU with --cpu
    from mercury_tpu_torch.convert import resolve_device
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.mode == "BER":
        from mercury_tpu_torch.channel.ber import BerHarness
        h = BerHarness(args.config, device=device)
        p = h.run_point(args.esn0, args.frames)
        print(f"cfg{args.config} Es/N0={args.esn0:+.1f} dB: "
              f"FER={p.fer:.4f} BER={p.ber:.6f} ({p.frames} frames)")
        return 0

    if args.mode == "SWEEP":
        from mercury_tpu_torch.channel.ber import BerHarness
        h = BerHarness(args.config, device=device)
        lo = int(args.esn0) - 4
        sweep = h.sweep(range(lo + 8, lo - 1, -1), n_frames=args.frames,
                        verbose=True)
        print(f"waterfall(FER<0.1): {sweep.waterfall(0.1)} dB")
        return 0

    if args.mode == "TX_TEST":
        from mercury_tpu_torch.core.geometry import build_geometry
        from mercury_tpu_torch.modem.tx import TxChain
        g = build_geometry(args.config, estimator=args.estimator,
                           carrier_offset_hz=carrier_off)
        tx = TxChain(g, device=device)
        data = (sys.stdin.buffer.read(g.frame_bytes) if args.input in (None, "-")
                else open(args.input, "rb").read(g.frame_bytes))
        pb = _transmit(tx, data, g.frame_bytes)
        out = args.output or "tx_frame.f32"
        pb.astype(np.float32).tofile(out)
        print(f"wrote {len(pb)} samples ({len(pb)/48000:.2f}s) to {out}")
        return 0

    if args.mode == "RX_TEST":
        from mercury_tpu_torch.core.geometry import build_geometry
        from mercury_tpu_torch.modem.rx import RxChain
        g = build_geometry(args.config, estimator=args.estimator,
                           carrier_offset_hz=carrier_off)
        rx = RxChain(g, device=device, **_rx_kwargs(args))
        samples = np.fromfile(args.input, dtype=np.float32)
        buf_len = g.nofdm * g.buffer_nsymb * g.interp
        buf = np.zeros(buf_len, np.float32)
        n = min(len(samples), buf_len)
        buf[:n] = samples[:n]
        ok, delay, snr, _cfo, payload = _receive(rx, buf)
        print(f"decoded={ok} delay={delay} snr={snr:.1f} dB")
        if ok:
            sys.stdout.buffer.write(payload)
            sys.stdout.buffer.flush()
        return 0 if ok else 1

    if args.mode == "SIM":
        from mercury_tpu_torch.link import protocol as P
        from mercury_tpu_torch.link.node import ArqConfig, ArqNode
        from mercury_tpu_torch.link.sim import ChannelModel, LinkSimulator
        cfg = ArqConfig(init_configuration=args.config,
                        carrier_offset_hz=carrier_off,
                        gear_shift_on=bool(args.gearshift),
                        robust_enabled=bool(args.robust),
                        turboshift=bool(args.turbo),
                        wire_compat=bool(ini.wire_compat),
                        rx_profile=args.rx_profile or ini.rx_profile)
        cmd = ArqNode("VE3TPU", P.COMMANDER, cfg, device=device)
        rsp = ArqNode("N0CALL", P.RESPONDER, cfg, device=device)
        sim = LinkSimulator(cmd, rsp, ChannelModel(snr_db=args.snr))
        # timestamped event log (parseable by tools/analyze_link_log.py)
        cmd.on_event = lambda e: print(f"{sim.now / 1000:9.2f} CMD: {e}")
        rsp.on_event = lambda e: print(f"{sim.now / 1000:9.2f} RSP: {e}")
        payload = bytes(np.random.default_rng(0).integers(0, 256, args.bytes)
                        .astype(np.uint8))
        cmd.send_data(payload)
        cmd.connect("N0CALL")
        t = sim.run(max_sim_s=3600,
                    until=lambda: len(rsp.fifo_rx) >= len(payload))
        got = rsp.received()
        print(f"sim {t:.1f}s: {len(got)}/{len(payload)} bytes "
              f"({'OK' if got == payload else 'MISMATCH'}), "
              f"final config {cmd.current_configuration}, "
              f"{len(got) * 8 / max(t, 1e-9):.0f} bps effective")
        ok = got == payload
        if ok and args.reverse_bytes:
            # hand the link to the peer and pull data back (SWITCH_ROLE;
            # with --turbo the new commander re-probes its own direction)
            rev = bytes(np.random.default_rng(1)
                        .integers(0, 256, args.reverse_bytes).astype(np.uint8))
            rsp.send_data(rev)
            cmd.switch_role()
            t2 = sim.run(max_sim_s=3600,
                         until=lambda: len(cmd.fifo_rx) >= len(rev))
            back = cmd.received()
            print(f"reverse {t2:.1f}s: {len(back)}/{len(rev)} bytes "
                  f"({'OK' if back == rev else 'MISMATCH'}), "
                  f"final config {rsp.current_configuration}")
            ok = ok and back == rev
        return 0 if ok else 1

    if args.mode == "ARQ":
        import time
        from mercury_tpu_torch.link.tcp_api import ArqTcpServer
        srv = ArqTcpServer(base_port=args.port, config=ini.arq_config(),
                           device=device)
        srv.node.call_sign = ini.my_callsign
        srv.start()
        print(f"ARQ service on control port {args.port}, data port {args.port + 1}")
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            srv.stop()
        return 0

    if args.mode in ("TX_SHM", "RX_SHM"):
        # Simplex shm payload modes (reference: main.cc:821-862 TX_SHM/RX_SHM
        # through the "/mercury-comm" ring; see examples/ for clients).
        import time as _time

        from mercury_tpu_torch.core.geometry import build_geometry
        from mercury_tpu_torch.runtime import ShmPayloadRing

        g = build_geometry(args.config, estimator=args.estimator,
                           carrier_offset_hz=carrier_off)
        ring = ShmPayloadRing(args.shm, 131072, create=True)
        out_path = args.output or ("tx_shm_stream.f32" if args.mode == "TX_SHM"
                                   else None)
        print(f"{args.mode} on shm '{args.shm}', config {args.config}, "
              f"frame={g.frame_bytes}B")
        try:
            if args.mode == "TX_SHM":
                from mercury_tpu_torch.modem.tx import TxChain
                tx = TxChain(g, device=device)
                with open(out_path, "ab") as f:
                    while True:
                        chunk = ring.read(g.frame_bytes)
                        if not chunk:
                            _time.sleep(0.05)
                            continue
                        pb = _transmit(tx, chunk, g.frame_bytes)
                        pb.astype(np.float32).tofile(f)
                        f.flush()
                        print(f"TX {len(chunk)}B -> {len(pb)} samples")
            else:
                from mercury_tpu_torch.modem.rx import RxChain
                rx = RxChain(g, device=device, **_rx_kwargs(args))
                buf_len = g.nofdm * g.buffer_nsymb * g.interp
                stream = np.fromfile(args.input, dtype=np.float32)
                pos = 0
                while pos < len(stream):
                    win = np.zeros(buf_len, np.float32)
                    n = min(buf_len, len(stream) - pos)
                    win[:n] = stream[pos: pos + n]
                    ok, delay, _snr, _cfo, payload = _receive(rx, win)
                    if ok:
                        ring.write(payload)
                        print(f"RX frame @ {pos + delay}"
                              f" -> {len(payload)}B to shm")
                        pos += delay + g.total_frame_size
                    else:
                        pos += buf_len // 2
                print("stream exhausted; waiting for ring drain")
                t0 = _time.monotonic()
                while len(ring) > 0 and _time.monotonic() - t0 < 30:
                    _time.sleep(0.1)
        except KeyboardInterrupt:
            pass
        finally:
            ring.close()
        return 0

    if args.mode == "MONITOR":
        # terminal dashboard over a sample stream (the ImGui GUI stand-in):
        # replays -i file.f32 in buffer-sized chunks, decoding and rendering
        # waterfall / constellation / readouts per chunk
        from mercury_tpu_torch.core.geometry import build_geometry
        from mercury_tpu_torch.dashboard import Dashboard, level_dbfs
        from mercury_tpu_torch.modem.rx import RxChain

        g = build_geometry(args.config, estimator=args.estimator,
                           carrier_offset_hz=carrier_off)
        rx = RxChain(g, device=device, **_rx_kwargs(args))
        dash = Dashboard(color=sys.stdout.isatty())
        stream = np.fromfile(args.input, dtype=np.float32)
        buf_len = g.nofdm * g.buffer_nsymb * g.interp
        pos = 0
        noise_floor = None
        vis = None
        while pos < len(stream):
            win = np.zeros(buf_len, np.float32)
            n = min(buf_len, len(stream) - pos)
            win[:n] = stream[pos: pos + n]
            ok, _delay, snr, cfo, _payload = _receive(rx, win)
            # idle-channel signal strength + noise floor (reference
            # measure_signal_only path, telecom_system.cc:1520-1541)
            dbm = float(rx.measure_signal_dbm(win[None]).cpu()[0])
            if not ok:
                noise_floor = (dbm if noise_floor is None
                               else noise_floor + 0.2 * (dbm - noise_floor))
            state = {"config": args.config,
                     "link_status": "DECODED" if ok else "SEARCHING",
                     "snr_db": snr,
                     "cfo_hz": cfo,
                     "signal_dbm": dbm, "noise_floor_dbm": noise_floor,
                     "rx_level_dbfs": level_dbfs(win)}
            const = None
            if ok and not g.spec.is_mfsk:
                from mercury_tpu_torch.obs import rx_diagnostics
                const = rx_diagnostics(rx, win).get("constellation")
            dash.update_samples(win)
            if args.gui is not None:
                if vis is None:
                    from mercury_tpu_torch.gui import VisualMonitor
                    live = args.gui == "live"
                    vis = VisualMonitor(interactive=live)
                    if live:
                        vis.show()
                vis.update(win, const, state)
                if args.gui == "live":
                    vis.pump()
            if sys.stdout.isatty():
                sys.stdout.write(dash.clear_screen())
            print(dash.frame(state, const))
            pos += buf_len
        if vis is not None and args.gui not in (None, "live"):
            vis.snapshot(args.gui)
            print(f"monitor snapshot written to {args.gui}")
        return 0

    if args.mode == "BENCH":
        from mercury_tpu_torch import bench
        return bench.main(["--cpu"] if args.cpu else [])

    return 1


def _transmit(tx, data: bytes, frame_bytes: int) -> np.ndarray:
    """One frame of payload bytes (zero-padded) -> host passband [n]."""
    row = np.frombuffer(data.ljust(frame_bytes, b"\0"), np.uint8)[None]
    return tx.transmit(torch.from_numpy(row.copy())).cpu().numpy()[0]


def _receive(rx, buf: np.ndarray):
    """A batch-1 receive of one capture window, its results read in one
    copy -> (crc_ok, delay, snr_db, freq_offset, payload bytes)."""
    from mercury_tpu_torch.convert import host_rows
    res = rx.receive(buf[None])
    row = host_rows(res.crc_ok, res.delay, res.snr_db, res.freq_offset,
                    res.payload)[0]
    return (bool(row[0]), int(row[1]), float(row[2]), float(row[3]),
            bytes(row[4:].astype(np.uint8)))


if __name__ == "__main__":
    sys.exit(main())
