"""The readings that the limits of `correct` are set from, and the sweep
that sizes a cell's pool: the program's numbers over many seeds or pool
sizes, and its control's.

    python3 -m benchmark.readings --workload c16_pool16384_threshold \
        --seeds 1 2 3 --seconds 6 [--control] [--channels 512 1024 ...]

Runs the cell at its own size (or at each of --channels, with
--ring-blocks blocks), each seed with its own ring, in one process (the
set-up of the kernels and the context paid once), and prints one JSON
line a run: the numbers compared, the rounds run, the end-to-end metrics
and the memory peak. With --control the pool's receive takes the cell's
control options (its workload file's "control"), which break a guarantee
of the configuration; the benchmark's own runs never do. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import harness


def readings(workload: str, seeds, seconds: float, control: bool,
             device: torch.device, cell: dict | None = None) -> list[dict]:
    cell = cell or harness.load_cell(workload)
    opts = cell["control"]["rx_options"] if control else None
    out = []
    for seed in seeds:
        run, checks = harness.serve(cell, seed, seconds, False, device,
                                    time.perf_counter(), {}, rx_options=opts)
        metrics = {m["name"]: harness.reader(m["name"])(run)
                   for m in harness.cell_metrics(False)}
        out.append({"seed": seed, "arm": "control" if control else "program",
                    "channels": run.channels, "rounds": len(run.rounds),
                    "correct": harness.is_correct(checks), "checks": checks,
                    "metrics": metrics, "setup_parts": run.setup_parts,
                    "memory_peak_bytes":
                        torch.cuda.max_memory_allocated(device)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.readings",
                                 description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--channels", type=int, nargs="+")
    ap.add_argument("--ring-blocks", type=int)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if args.ring_blocks:
        cell["ring_blocks"] = args.ring_blocks
    for n in args.channels or [cell["channels"]]:
        for row in readings(args.workload, args.seeds, args.seconds,
                            args.control, torch.device("cuda", 0),
                            {**cell, "channels": n}):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
