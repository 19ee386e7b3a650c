"""ACK/BREAK tone-pattern detection against SNR, and false alarms, with the
port's PatternSignaler (the counterpart of the repo root's
tools/pattern_detect_sweep.py).

The reference's MFSK BER mode runs ack_pattern_detection_test
(telecom_system.cc:1712-1802): an SNR sweep of the detection metric plus a
noise-only false-alarm branch at the -10 dB noise level. The sweep batches
hundreds of trials a point, gives the detection probability at the shipping
threshold (0.65 on ROBUST_0, 1.0 on the OFDM modes;
telecom_system.cc:3010-3019), alone and gated by half the symbols matched
(arq_common.cc:2582-2583), the cross-pattern confusion (the ACK waveform
into the BREAK detector and back), and the false-alarm count.

The noise is numpy's default_rng(7), drawn in the JAX tool's order with its
sigma calibration, so both tools score the same buffers; the detector runs
on the CUDA card unless --cpu is given. Without a card and without --cpu it
exits 1.

    python -m mercury_tpu_torch.tools.pattern_detect_sweep --out docs/pattern_detect_h100.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from mercury_tpu_torch.convert import card_meta, cli_device
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.modem.patterns import PatternSignaler


def sweep(config: int, trials: int, fa_trials: int, batch: int,
          snr_lo: float, snr_hi: float, device) -> dict:
    """The detection sweep (SNR snr_lo..snr_hi in 1 dB steps, `trials` a
    point and transmitted pattern) and the false-alarm branch (`fa_trials`
    noise-only buffers), `batch` buffers a detector call -> {"meta",
    "detection", "false_alarm"} with the JAX tool's keys."""
    g = build_geometry(config, with_pre_eq=False)
    sig = PatternSignaler(g, device=device)
    thr = sig.threshold
    delay = 2 * g.nofdm * g.interp
    t0 = time.time()

    waves = {"ack": np.asarray(sig.ack_passband, np.float32),
             "break": np.asarray(sig.break_passband, np.float32)}
    detectors = {"ack": sig.detect_ack, "break": sig.detect_break}
    n_pat = waves["ack"].shape[-1]
    buf_len = n_pat + 2 * delay          # reference rx_buffer_size
    f_nyq = g.fs / 2.0
    half = sig.ack_mfsk.ack_pattern_nsymb // 2

    def sigma_for(snr_db: float, p_sig: float) -> float:
        # reference sigma calibration (telecom_system.cc:1749):
        # sigma^2 = 2 P_sig f_nyq / (10^(snr/10) bandwidth); noise added
        # with amplitude sigma/sqrt(2) per real sample
        return float(np.sqrt(2.0 * p_sig * f_nyq
                             / (10 ** (snr_db / 10.0) * g.bandwidth))
                     / np.sqrt(2.0))

    def detect(det, buf):
        m, cnt = det(buf)
        return m.cpu().numpy(), cnt.cpu().numpy()

    results = {"meta": {**card_meta(sig.device), "config": config,
                        "threshold": thr, "trials": trials,
                        "fa_trials": fa_trials,
                        "pattern_nsymb": int(sig.ack_mfsk.ack_pattern_nsymb),
                        "reference": "telecom_system.cc:1712-1802"},
               "detection": [], "false_alarm": {}}

    rng = np.random.default_rng(7)
    snrs = np.arange(snr_lo, snr_hi + 0.5, 1.0)
    for tx_name, wave in waves.items():
        p_sig = float(np.mean(wave ** 2))
        for snr in snrs:
            sigma = sigma_for(snr, p_sig)
            mets = {d: [] for d in detectors}
            done = 0
            while done < trials:
                b = min(batch, trials - done)
                buf = sigma * rng.standard_normal((b, buf_len)
                                                  ).astype(np.float32)
                buf[:, delay: delay + n_pat] += wave[None]
                for d_name, det in detectors.items():
                    mets[d_name].append(detect(det, buf))
                done += b
            row = {"tx": tx_name, "snr_db": float(snr)}
            # the link layer gates metric >= threshold AND matched >=
            # NSYMB/2 (reference arq_common.cc:2582-2583, 2861-2862) —
            # report both, plus the OFDM threshold 1.0 variant
            for d_name in detectors:
                m = np.concatenate([x[0] for x in mets[d_name]])
                c = np.concatenate([x[1] for x in mets[d_name]])
                row[f"pdet_{d_name}"] = round(float((m >= thr).mean()), 4)
                row[f"pdet_{d_name}_gated"] = round(float(
                    ((m >= thr) & (c >= half)).mean()), 4)
                row[f"pdet_{d_name}_gated_thr1"] = round(float(
                    ((m >= 1.0) & (c >= half)).mean()), 4)
                row[f"metric_{d_name}"] = [round(float(m.mean()), 3),
                                           round(float(m.min()), 3),
                                           round(float(m.max()), 3)]
                row[f"matched_{d_name}_mean"] = round(float(c.mean()), 2)
            results["detection"].append(row)
            print(f"tx={tx_name} snr={snr:+.0f}: "
                  f"Pdet(ack)={row['pdet_ack']:.3f} "
                  f"Pdet(break)={row['pdet_break']:.3f} "
                  f"mean_m={row[f'metric_{tx_name}'][0]:.2f}", flush=True)

    # false-alarm branch: noise only at the reference's -10 dB noise level
    p_sig = float(np.mean(waves["ack"] ** 2))
    sigma = sigma_for(-10.0, p_sig)
    fa = {d: 0 for d in detectors}
    fa_gated = {d: 0 for d in detectors}
    max_m = {d: 0.0 for d in detectors}
    done = 0
    while done < fa_trials:
        b = min(batch, fa_trials - done)
        buf = sigma * rng.standard_normal((b, buf_len)).astype(np.float32)
        for d_name, det in detectors.items():
            m, cnt = detect(det, buf)
            fa[d_name] += int((m >= thr).sum())
            fa_gated[d_name] += int(((m >= thr) & (cnt >= half)).sum())
            max_m[d_name] = max(max_m[d_name], float(m.max()))
        done += b
    for d_name in detectors:
        results["false_alarm"][d_name] = {
            "trials": fa_trials, "alarms": fa[d_name],
            "alarms_gated": fa_gated[d_name],
            "rate": round(fa[d_name] / fa_trials, 5),
            "max_noise_metric": round(max_m[d_name], 3),
            "threshold": thr}
        print(f"false alarm [{d_name}]: {fa[d_name]}/{fa_trials} "
              f"(max noise metric {max_m[d_name]:.3f}, thr {thr})",
              flush=True)
    results["meta"]["seconds"] = round(time.time() - t0, 1)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mercury_tpu_torch.tools.pattern_detect_sweep",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", type=int, default=100,
                    help="mode geometry (100=ROBUST_0, threshold 0.65; "
                         "OFDM configs use threshold 1.0)")
    ap.add_argument("--trials", type=int, default=256)
    ap.add_argument("--fa-trials", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--snr-lo", type=float, default=-20.0)
    ap.add_argument("--snr-hi", type=float, default=5.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = cli_device(args.cpu)
    if device is None:
        return 1
    results = sweep(args.config, args.trials, args.fa_trials, args.batch,
                    args.snr_lo, args.snr_hi, device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
