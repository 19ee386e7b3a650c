"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload c9_pool4096_clean --seed 7 \
        --seconds 20 --trace 0

Needs a CUDA card (exit 2 and no result without one, or with fewer cards
than the cell asks for). Set-up: the program's kernels (built once into
build/mercury_tpu_torch/ inside the checkout), the cell's ring of capture
blocks from the seed, the serving pool, three warm rounds; then
rounds for --seconds. The last line of standard output is one JSON object:
correct, attempted, failed, metrics (--trace 0: the cell's end-to-end
metrics; --trace 1: its per-layer ones, from a profiled stretch after
the window), device (and with --trace 1 breakdown), and last the
numbers compared with their limits, also the last lines on standard error.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / "benchmark" / sub))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.run", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness
    age = harness.process_age_s()
    t_start = T_IMPORT if age is None else time.perf_counter() - age
    import torch
    from benchmark import yardstick
    parts = {"import_torch_s": time.perf_counter() - t_start}

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(1)
    t = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    parts["cuda_context_s"] = time.perf_counter() - t

    run, checks = harness.serve(cell, args.seed, args.seconds,
                                bool(args.trace), device, t_start, parts)
    peak = torch.cuda.max_memory_allocated(device)
    found = harness.forbidden_modules()
    if found:
        log(f"loaded in this process: {', '.join(found)}")
        return 3

    metrics = {}
    for m in harness.cell_metrics(bool(args.trace)):
        value = harness.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    frames = [r[3] for r in run.rounds]
    times = sorted((r[2] - r[0]) * 1e3 for r in run.rounds)
    log(f"set-up {run.setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup_parts.items()))
    log(f"window {run.window_s:.3f} s, {len(run.rounds)} rounds, round ms "
        f"median {yardstick.nearest_rank(times, 0.5):.3f} p95 "
        f"{yardstick.nearest_rank(times, 0.95):.3f} max {times[-1]:.3f}; "
        f"frames delivered {sum(frames)} of {run.channels * len(frames)}")
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": 1, "memory_peak_bytes": peak}
    wrong = checks["wrong_share"]
    result = {"correct": harness.is_correct(checks),
              "attempted": run.channels * len(run.rounds),
              "failed": wrong["frames"],
              "metrics": metrics, "device": device_info}
    if run.trace is not None:
        tr = run.trace
        busy, _ = yardstick.busy_union([(s, e) for _, s, e in tr.device_ops],
                                       tr.lo, tr.hi)
        device_info["busy_s"] = busy * 1e-6
        device_info["window_s"] = tr.wall_s
        result["breakdown"] = harness.breakdown(tr)
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in checks.items()}
    print(json.dumps(result), flush=True)
    for k, v in checks.items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
