#!/usr/bin/env python3
"""How to drive the shards of a receive on one CUDA card: from one thread
or from a thread each, and why a quarter batch costs what it does.

    PYTHONPATH=. python3 tools/profile_shard_threads.py [--config 9]
        [--reps 4]

A batch-256 capture buffer (random payloads from seed 909 at the bench.py
delay, white noise at 12 dB Es/N0), split into 4 x 64 rows, each quarter
received by its own chain (RxChain.replica) on its own stream: from the
calling thread in turn (what scale.shard does) and from 4 kept threads at
once (the design scale.shard dropped); beside them the unsharded receive,
one quarter alone (the caller's chain on the default stream, and a replica
on its own stream), and scale.shard.channel_parallel_receive on virtual
meshes of 1, 2 and 4 shards. Each figure: reps calls after a warm-up, host
clock around the call ending in a synchronize, in ms. Then one profiled
call each of the unsharded receive and the two single quarters: wall ms,
device busy ms (the union of the card's kernel, copy and set intervals),
idle share, kernels on the card, host synchronizations, and the host ops
with the most self CPU time. Prints the card's name and power limit first.
Needs a card; exits 1 without one.
"""

import argparse
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain
from mercury_tpu_torch.scale import shard

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def walls(fn, reps: int) -> list[float]:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(round((time.perf_counter() - t0) * 1e3, 2))
    return out


def profiled(fn) -> dict:
    """One call of fn under the profiler (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    evs = list(prof.profiler.kineto_results.events())
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in evs if e.device_type() == cuda)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    kernels = sum(1 for e in evs if e.device_type() == cuda
                  and "Memcpy" not in e.name() and "Memset" not in e.name())
    syncs = sum(1 for e in evs if e.name() in SYNCS)
    top = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {"wall_ms": round(wall, 2), "busy_ms": round(busy / 1e6, 3),
            "idle": round(1 - busy / 1e6 / wall, 3), "kernels": kernels,
            "host_syncs": syncs,
            "top_host_us": [(a.key, round(a.self_cpu_time_total), a.count)
                            for a in top[:6]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", type=int, default=9)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_shard_threads: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = build_geometry(args.config)
    rx = RxChain(g, device=dev)
    gen = torch.Generator(device=dev).manual_seed(909)
    payload = torch.randint(0, 256, (256, g.frame_bytes), generator=gen,
                            device=dev, dtype=torch.uint8)
    buf = sim.awgn_passband(
        TxChain(g, device=dev).transmit(payload), sim.sigma_for_esn0(12.0),
        ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp,
        g.nofdm * g.buffer_nsymb * g.interp, gen)
    chains = [rx.replica(dev) for _ in range(4)]
    streams = [torch.cuda.Stream(dev) for _ in range(4)]
    parts = list(buf.chunk(4))

    def quarter(i):
        with torch.cuda.stream(streams[i]):
            chains[i].receive(parts[i])

    pool = ThreadPoolExecutor(4)
    rows = {
        "unsharded [256]": lambda: rx.receive(buf),
        "one quarter [64], default stream": lambda: rx.receive(parts[0]),
        "one quarter [64], replica on its own stream": lambda: quarter(0),
        "4 quarters, one thread": lambda: [quarter(i) for i in range(4)],
        "4 quarters, 4 threads": lambda: list(pool.map(quarter, range(4))),
    }
    for label, fn in rows.items():
        print(f"CONFIG_{args.config} {label}: ms {walls(fn, args.reps)}")
    pool.shutdown()
    for n in (1, 2, 4):
        run = shard.channel_parallel_receive(
            rx, shard.make_mesh(n, devices=[dev] * n))
        print(f"CONFIG_{args.config} channel_parallel_receive, {n} shards: "
              f"ms {walls(lambda: run(buf), args.reps)}")
    for label in ("unsharded [256]", "one quarter [64], default stream",
                  "one quarter [64], replica on its own stream"):
        print(f"CONFIG_{args.config} {label}, profiled: "
              f"{profiled(rows[label])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
