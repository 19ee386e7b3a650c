"""BER waterfall campaign of the port: every mode x pilot density x harness
convention (the counterpart of the repo root's tools/ber_campaign.py).

For each job it searches the waterfall, the lowest Es/N0 (or channel SNR)
whose confirmed FER is below 0.1, with the port's BerHarness on the CUDA
card (batch 256 by default), under the harness conventions of the JAX
records docs/ber_r4b.json and docs/ber_r5.json:

- baseband: the reference baseband_test_EsN0 convention (sigma =
  10^(-EsN0/20) on 1/sqrt(Nfft)-normalized symbols, per-carrier Es/N0: the
  convention of the documented table, common_defines.h:129-148);
- passband: the same sigma on the passband waveform through the whole
  receive; the effective per-carrier Es/N0 is the parameter plus
  front_end_delta, measured per config;
- mfsk / mfsk_fixed: the MFSK channel-SNR convention (sigma from the
  measured TX power, telecom_system.cc:271-288), with time sync or at the
  known delay (telecom_system.cc:663-673);
- ctrl / ctrl_fixed: the punctured control frames of ROBUST_0/1.

    python -m mercury_tpu_torch.tools.ber_campaign --out docs/ber_campaign_h100.json \\
        --harness pb --density high --configs 0 1 2 3

The output is written after every job, and a rerun skips the (config,
density, harness) triples already in it, so a campaign is run in chunks
(--configs) and resumed. --compare prints a record's effective waterfalls
beside the JAX records' (no device needed):

    python -m mercury_tpu_torch.tools.ber_campaign --out docs/ber_campaign_h100.json \\
        --compare docs/ber_r4b.json docs/ber_r5.json

Without a card and without --cpu it exits 1; it
never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

from mercury_tpu_torch.channel.ber import BerHarness
from mercury_tpu_torch.convert import card_meta, cli_device
from mercury_tpu_torch.core.modes import HIGH_DENSITY, LOW_DENSITY

# Documented Es/N0 @ FER<0.1 (common_defines.h:129-148); MFSK rows are
# channel SNR (telecom_system.cc:2642)
DOCUMENTED = {0: -10.0, 1: -7.5, 2: -6.0, 3: -4.5, 4: -3.5, 5: -2.5,
              6: -1.5, 7: -0.5, 8: 0.5, 9: 1.5, 10: 3.0, 11: 4.0,
              12: 6.5, 13: 7.5, 14: 9.0, 15: 12.5, 16: 13.5,
              100: -13.0, 101: -11.0, 102: -8.0}

OFDM_CFGS = list(range(17))
MFSK_CFGS = [100, 101, 102]
HARNESSES = {"all": None, "bb": ("baseband",), "pb": ("passband",),
             "mfsk": ("mfsk", "mfsk_fixed"), "ctrl": ("ctrl", "ctrl_fixed")}
DENSITIES = {"both": [("high", HIGH_DENSITY), ("low", LOW_DENSITY)],
             "high": [("high", HIGH_DENSITY)],
             "low": [("low", LOW_DENSITY)]}


def find_waterfall(run_fn, start: float, step: float, n_scan: int,
                   n_confirm: int, max_offset: float, log):
    """Ascending scan at n_scan frames/point; once FER dips below 0.07,
    confirm (with n_confirm frames) the half-step below and the point itself;
    waterfall = lowest confirmed Es/N0 with FER < 0.1."""
    points = []
    e = start
    cand = None
    while e <= start + max_offset + 1e-9:
        p = run_fn(e, n_scan)
        points.append(p)
        log(f"  scan {e:+.2f} dB: FER={p.fer:.3f} ({p.frames} fr)")
        if p.fer < 0.07:
            cand = e
            break
        e += step
    if cand is None:
        return points, None
    wf = None
    for e2 in (cand - step / 2, cand):
        p = run_fn(e2, n_confirm)
        points.append(p)
        log(f"  confirm {e2:+.2f} dB: FER={p.fer:.4f} ({p.frames} fr)")
        if p.fer < 0.1:
            wf = e2
            break
    while wf is None and cand <= start + max_offset:
        cand += step
        p = run_fn(cand, n_confirm)
        points.append(p)
        log(f"  confirm {cand:+.2f} dB: FER={p.fer:.4f} ({p.frames} fr)")
        if p.fer < 0.1:
            wf = cand
    # refine downward in half-steps while the confirmation still passes
    for _ in range(6):
        if wf is None:
            break
        e3 = wf - step / 2
        p = run_fn(e3, n_confirm)
        points.append(p)
        log(f"  refine {e3:+.2f} dB: FER={p.fer:.4f} ({p.frames} fr)")
        if p.fer < 0.1:
            wf = e3
        else:
            break
    return points, wf


def jobs(harness: str = "all", density: str = "both",
         configs=None) -> list[tuple]:
    """The JAX tool's job list, in its order: baseband (both densities),
    passband, then MFSK and the control frames (high density) ->
    [(config, density name, density, harness)]."""
    dens = DENSITIES[density]
    want = HARNESSES[harness]
    out = []
    for h in ("baseband", "passband"):
        if want is None or h in want:
            out += [(c, dname, d, h) for dname, d in dens for c in OFDM_CFGS]
    for h, cfgs in (("mfsk", MFSK_CFGS), ("ctrl", (100, 101))):
        for c in cfgs:
            for name in (h, f"{h}_fixed"):
                if want is None or name in want:
                    out.append((c, "high", HIGH_DENSITY, name))
    if configs is not None:
        out = [j for j in out if j[0] in configs]
    return out


def run_job(cfg: int, dname: str, dens: int, harness: str, batch: int,
            n_scan: int, n_confirm: int, device, log) -> dict:
    """One job's waterfall search -> its entry (the JAX tool's keys)."""
    t0 = time.time()
    log(f"=== cfg{cfg} {dname} {harness} ===")
    h = BerHarness(cfg, batch=batch, pilot_density=dens,
                   ctrl=harness.startswith("ctrl"), device=device)
    doc = DOCUMENTED.get(cfg)
    delta = None
    if harness == "baseband":
        run_fn = h.run_point_baseband
        start = (doc if doc is not None else 0.0) - 2.0
        step, max_off = 0.5, 26.0
    elif harness == "passband":
        delta = h.front_end_delta()
        log(f"  front-end delta = {delta:+.2f} dB "
            f"(effective EsN0 = parameter {delta:+.2f})")
        run_fn = h.run_point
        start = (doc if doc is not None else 0.0) - delta - 2.0
        step, max_off = 0.5, 26.0
    else:  # mfsk/ctrl channel-SNR convention (sync-on or fixed-delay)
        run_fn = (functools.partial(h.run_point, fixed_delay=True)
                  if harness.endswith("_fixed") else h.run_point)
        start = (doc if doc is not None else -14.0) - 3.0
        step, max_off = 0.5, 20.0
    points, wf = find_waterfall(run_fn, start, step, n_scan, n_confirm,
                                max_off, log)
    return {
        "config": cfg, "density": dname, "harness": harness,
        "delta_db": None if delta is None else round(delta, 3),
        "documented_db": doc,
        "waterfall_fer10": wf,
        "effective_waterfall_db": (None if wf is None else
                                   round(wf + (delta or 0.0), 2)),
        "gap_vs_documented_db": (None if (wf is None or doc is None) else
                                 round(wf + (delta or 0.0) - doc, 2)),
        "points": [[p.esn0_db, p.frames, p.frame_errors,
                    round(p.fer, 5), round(p.ber, 7)] for p in points],
        "seconds": round(time.time() - t0, 1),
    }


def campaign(out_path: str, job_list, batch: int, n_scan: int,
             n_confirm: int, device, log=print) -> dict:
    """Run job_list into out_path, saving after every job; the triples
    already in out_path are skipped -> the whole record."""
    results = {"meta": {**card_meta(device), "scan_frames": n_scan,
                        "confirm_frames": n_confirm, "batch": batch},
               "results": []}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    done = {(r["config"], r["density"], r["harness"])
            for r in results["results"]}

    def save():
        tmp = out_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results, f, indent=1)
        os.replace(tmp, out_path)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    for cfg, dname, dens, harness in job_list:
        if (cfg, dname, harness) in done:
            continue
        entry = run_job(cfg, dname, dens, harness, batch, n_scan, n_confirm,
                        device, log)
        results["results"].append(entry)
        done.add((cfg, dname, harness))
        save()
        log(f"  -> waterfall {entry['waterfall_fer10']} dB (effective "
            f"{entry['effective_waterfall_db']}, doc {entry['documented_db']}"
            f", gap {entry['gap_vs_documented_db']}) in {entry['seconds']}s")
    save()
    return results


def compare(ours: dict, records: list[dict]) -> list[dict]:
    """Each waterfall of the record `ours` beside the same (config,
    density, harness) in the JAX records (a later record replaces an
    earlier one's entry) -> rows of effective waterfalls (dB): "port",
    "jax" (None where no record holds it), "documented" and "diff" = port -
    jax, with "worse" where the port is more than one refine half-step
    (0.25 dB) above the record."""
    theirs = {}
    for rec in records:
        theirs.update({(r["config"], r["density"], r["harness"]): r
                       for r in rec["results"]})
    rows = []
    for r in sorted(ours["results"], key=lambda r: (
            r["harness"], r["density"], r["config"])):
        t = theirs.get((r["config"], r["density"], r["harness"]))
        port = r["effective_waterfall_db"]
        jax = None if t is None else t["effective_waterfall_db"]
        diff = None if port is None or jax is None else round(port - jax, 2)
        rows.append({"config": r["config"], "density": r["density"],
                     "harness": r["harness"], "port": port, "jax": jax,
                     "documented": r["documented_db"], "diff": diff,
                     "worse": diff is not None and diff > 0.25 + 1e-9})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mercury_tpu_torch.tools.ber_campaign",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True,
                    help="the record, read first and written after each job")
    ap.add_argument("--harness", default="all", choices=list(HARNESSES))
    ap.add_argument("--configs", type=int, nargs="*", default=None)
    ap.add_argument("--density", default="both", choices=list(DENSITIES))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--scan-frames", type=int, default=256)
    ap.add_argument("--confirm-frames", type=int, default=1024)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--compare", nargs="+", default=None, metavar="RECORD",
                    help="run nothing: print --out's waterfalls beside these "
                    "JAX records' (a later one replaces an earlier one's "
                    "entry) as a markdown table")
    args = ap.parse_args(argv)
    if args.compare:
        with open(args.out) as f:
            ours = json.load(f)
        records = []
        for path in args.compare:
            with open(path) as f:
                records.append(json.load(f))
        print("| harness | density | config | port dB | JAX dB | documented "
              "| port - JAX |\n|---|---|---:|---:|---:|---:|---:|")
        for r in compare(ours, records):
            print(f"| {r['harness']} | {r['density']} | {r['config']} | "
                  f"{r['port']} | {r['jax']} | {r['documented']} | "
                  f"{r['diff']}{' worse' if r['worse'] else ''} |")
        return 0
    device = cli_device(args.cpu)
    if device is None:
        return 1
    campaign(args.out, jobs(args.harness, args.density, args.configs),
             args.batch, args.scan_frames, args.confirm_frames, device,
             lambda m: print(m, flush=True))
    print("campaign complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
