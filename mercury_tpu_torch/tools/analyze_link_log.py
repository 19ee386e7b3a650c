#!/usr/bin/env python
"""Link-session log forensics — the TPU framework's equivalent of the
reference's tools/analyze_turboshift_log.py (event-timeline extraction from
verbose modem logs, SURVEY §4.4).

Parses timestamped node-event lines as emitted by `python -m mercury_tpu_torch -m
SIM`, the link simulator, or any harness wiring `ArqNode.on_event` to
`print(f"{t:9.2f} <ROLE>: <event>")`, and reports:

  - the normalized event timeline
  - per-config residency (seconds spent at each modulation config)
  - turboshift phases (start -> per-step OK -> DONE, with step timings)
  - gearshift/BREAK/reconnect counts and timings
  - connect/transfer phase durations

Usage: python -m mercury_tpu_torch.tools.analyze_link_log session.log [--json out.json]
       ... | python -m mercury_tpu_torch.tools.analyze_link_log -
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from collections import defaultdict

LINE_RE = re.compile(
    r"^\s*(?:t=)?(?P<t>\d+(?:\.\d+)?)\s+(?P<role>[A-Za-z]+):\s+(?P<event>.+?)\s*$")
CFG_RE = re.compile(r"(?:GEARSHIFT|TURBO OK|TURBO DONE|TURBO REVERT|"
                    r"BREAK\s*->(?:CONFIG)?|->)\s*(\d+)")


def parse_lines(lines):
    events = []
    for line in lines:
        m = LINE_RE.match(line)
        if not m:
            continue
        events.append({"t": float(m.group("t")), "role": m.group("role"),
                       "event": m.group("event")})
    return events


def analyze(events):
    out = {
        "n_events": len(events),
        "timeline": events,
        "counts": defaultdict(int),
        "config_residency_s": defaultdict(float),
        "turbo_phases": [],
        "breaks": [],
        "reconnects": [],
    }
    if not events:
        return out
    t_end = events[-1]["t"]

    # per-role config tracking (commander drives; track each role separately
    # and report the commander's residency)
    cur_cfg: dict[str, tuple[int, float]] = {}
    turbo_open = None
    connect_t = None

    for ev in events:
        t, role, text = ev["t"], ev["role"], ev["event"]
        key = text.split()[0] if text else ""
        out["counts"][key] += 1

        if text.startswith("CONNECTED") and connect_t is None:
            connect_t = t
            out["connect_s"] = t
        m = CFG_RE.search(text)
        if m and ("GEARSHIFT" in text or "TURBO OK" in text
                  or "TURBO REVERT" in text or "BREAK" in text):
            new_cfg = int(m.group(1))
            prev = cur_cfg.get(role)
            if prev is not None:
                out["config_residency_s"][(role, prev[0])] += t - prev[1]
            cur_cfg[role] = (new_cfg, t)
        if "TURBO START" in text:
            turbo_open = {"t_start": t, "steps": []}
        elif turbo_open is not None and "TURBO OK" in text:
            turbo_open["steps"].append(
                {"t": t, "config": int(text.rsplit(" ", 1)[1])})
        elif turbo_open is not None and "TURBO DONE" in text:
            turbo_open["t_done"] = t
            turbo_open["final_config"] = int(text.rsplit(" ", 1)[1])
            turbo_open["duration_s"] = t - turbo_open["t_start"]
            out["turbo_phases"].append(turbo_open)
            turbo_open = None
        if text.startswith("BREAK"):
            out["breaks"].append({"t": t, "role": role})
        if "RECONNECTING" in text:
            out["reconnects"].append({"t": t, "role": role})

    for role, (cfg, t0) in cur_cfg.items():
        out["config_residency_s"][(role, cfg)] += t_end - t0
    out["counts"] = dict(out["counts"])
    # per-role residency: {"CMD": {cfg: seconds}, ...}
    per_role: dict = defaultdict(dict)
    for (role, cfg), v in out["config_residency_s"].items():
        per_role[role][int(cfg)] = round(v, 2)
    out["config_residency_s"] = dict(per_role)
    return out


def render(a) -> str:
    lines = [f"events: {a['n_events']}"]
    if a.get("connect_s") is not None:
        lines.append(f"connected at t={a['connect_s']:.1f}s")
    lines.append("event counts: " + ", ".join(
        f"{k}={v}" for k, v in sorted(a["counts"].items())))
    for role, res in sorted(a["config_residency_s"].items()):
        lines.append(f"config residency [{role}] (s): " + ", ".join(
            f"cfg{k}: {v:.1f}" for k, v in sorted(res.items())))
    for i, ph in enumerate(a["turbo_phases"]):
        steps = " -> ".join(str(s["config"]) for s in ph["steps"])
        lines.append(f"turbo #{i}: {ph['duration_s']:.1f}s, "
                     f"{len(ph['steps'])} steps [{steps}] "
                     f"-> final cfg {ph['final_config']}")
    if a["breaks"]:
        lines.append("breaks at: " + ", ".join(f"{b['t']:.1f}s" for b in a["breaks"]))
    if a["reconnects"]:
        lines.append("reconnects at: " + ", ".join(
            f"{r['t']:.1f}s" for r in a["reconnects"]))
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("log", help="log file path, or - for stdin")
    ap.add_argument("--json", default=None, help="write full analysis JSON")
    args = ap.parse_args()
    lines = (sys.stdin if args.log == "-" else open(args.log)).readlines()
    a = analyze(parse_lines(lines))
    print(render(a))
    if args.json:
        json.dump(a, open(args.json, "w"), indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
