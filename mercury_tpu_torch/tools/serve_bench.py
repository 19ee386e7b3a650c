"""Serving benchmark of the port's pools on one CUDA card (the counterpart
of the repo root's tools/serve_bench.py).

    python -m mercury_tpu_torch.tools.serve_bench [--channels 64 256 1024]
        [--rounds 6] [--pools fused device host] [--cpu] [--out FILE.json]

Measures the serving runtime, not the receive alone: wall-clock over full
pool rounds (feed -> gather of every ready channel -> H2D -> ONE batched
receive -> D2H -> re-arming) at each channel count, against the rate of the
receive alone at the same batch (bench.receive_rate's difference of
chains). Steady state is lockstep: every channel carries one frame per
round at the same offset, so after the priming round every round re-arms
every channel alike and decodes all of them in one dispatch.

Per pool and channel count: ingest and processed Msamples/s, frames/s,
decoded frames per fed frame, real-time channels (ingest / 48 kHz), the
host-stage timing and, for FusedDevicePool, a budget of its line items
each measured on its own (H2D of the chunk, the round on the card, the
packed D2H, the dispatch round trip, the host unpack) against the wall.
One JSON line a row on stdout; --out writes them all (no default). Without
a card and without --cpu it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from mercury_tpu_torch import bench
from mercury_tpu_torch.convert import cli_device, describe, resolve_device
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain
from mercury_tpu_torch.scale import serve

CFG = 9


def _lockstep(g, pool, n_ch: int, device: torch.device):
    """The lockstep capture of n_ch channels (payloads from
    default_rng(100 + n_ch), noise 2e-3) -> (chunk samples, round_block(r)
    the block of round r, priming() the zeros before round 0)."""
    sym, frame_syms, buf_syms = pool.sym_len, pool.frame_syms, g.buffer_nsymb
    rng = np.random.default_rng(100 + n_ch)
    payload = rng.integers(0, 256, (n_ch, g.frame_bytes)).astype(np.uint8)
    frames = TxChain(g, device=device).transmit(
        torch.from_numpy(payload)).cpu().numpy()
    flen = frames.shape[1]
    # With full-chunk feeding the window advances one chunk per round, so
    # frame positions in the window are stationary at d = buf_syms -
    # chunk_syms + lead_syms, and one frame decodes per round iff the
    # re-arm (d + frame_syms) fits in one chunk: chunk >= (buf + frame +
    # lead)/2, and frames must not overlap (chunk >= frame + lead + 2).
    lead_syms = 2
    chunk_syms = max(frame_syms + lead_syms + 2,
                     -(-(buf_syms + frame_syms + lead_syms) // 2))
    chunk = chunk_syms * sym
    base_noise = (2e-3 * rng.standard_normal((n_ch, chunk))
                  ).astype(np.float32)

    def round_block(r: int) -> np.ndarray:
        blk = base_noise + np.float32(r * 1e-6)  # content-unique per round
        blk[:, lead_syms * sym: lead_syms * sym + flen] += frames
        return blk

    def priming() -> np.ndarray:
        return np.zeros((n_ch, max(buf_syms - chunk_syms, 0) * sym),
                        np.float32)

    return chunk, round_block, priming


def bench_pool(n_ch: int, rounds: int, log, kind: str = "host",
               device=None) -> dict:
    """StreamPool ("host": windows in host memory) or DeviceStreamPool
    ("device": windows on the card) over lockstep rounds."""
    device = resolve_device(device)
    g = build_geometry(CFG)
    pool = (serve.DeviceStreamPool if kind == "device"
            else serve.StreamPool)(g, n_ch, device=device)
    chunk, round_block, priming = _lockstep(g, pool, n_ch, device)

    # priming: fill the windows (armed buffer_nsymb at construction); the
    # first chunk's frame lands at the stationary position
    t_prime = time.perf_counter()
    pool.feed_block(priming())
    pool.feed_block(round_block(0))
    prime_res = pool.step()
    t_prime = time.perf_counter() - t_prime
    log(f"  priming: {len(prime_res)}/{n_ch} decoded ({t_prime:.1f}s incl. "
        f"first-call set-up)")

    decoded = 0
    rows0 = pool.rows_dispatched
    t_feed = t_step = 0.0
    t0 = time.perf_counter()
    for r in range(1, rounds + 1):
        tf = time.perf_counter()
        pool.feed_block(round_block(r))
        t_feed += time.perf_counter() - tf
        ts = time.perf_counter()
        decoded += len(pool.step())
        t_step += time.perf_counter() - ts
    wall = time.perf_counter() - t0
    ingest = n_ch * chunk * rounds
    rows = pool.rows_dispatched - rows0

    # H2D probe: what this machine's transfer path costs for the pool's
    # per-round upload (the pools' own pinned-memory path), so the row
    # separates transfer-bound from compute- or runtime-bound
    h2d_bytes_round = 4 * n_ch * (chunk if kind == "device"
                                  else pool.buf_len)
    up = np.zeros((n_ch, h2d_bytes_round // (4 * n_ch)), np.float32)
    t_h = time.perf_counter()
    serve._to_device(up, device)
    bench.sync(device)
    h2d_gbps = up.nbytes / (time.perf_counter() - t_h) / 1e9
    # two rates: ingest (what a real-time deployment must sustain per
    # channel) and processed (window samples through the whole receive:
    # rows x buf_len / wall, the rate comparable with the receive alone).
    # The host pool's step uploads its rows; the device pool's upload is
    # in feed_block, so its step moves no H2D (the JAX tool subtracts the
    # chunk's upload from the device pool's step all the same)
    step_s = t_step / rounds
    step_h2d = 0 if kind == "device" else h2d_bytes_round
    return {
        "pool": kind,
        "n_channels": n_ch,
        "rounds": rounds,
        "chunk_samples_per_channel": chunk,
        "h2d_probe_gbytes_per_s": h2d_gbps,
        "h2d_bytes_per_round": h2d_bytes_round,
        "dispatch_ex_h2d_s_per_round": max(
            step_s - step_h2d / (h2d_gbps * 1e9), 0.0),
        "pool_ingest_msamples_per_s": ingest / wall / 1e6,
        "pool_processed_msamples_per_s": rows * pool.buf_len / wall / 1e6,
        "frames_per_s": decoded / wall,
        "decoded_per_fed_frame": decoded / (n_ch * rounds),
        "realtime_channels": int(ingest / wall / 48000),
        "host_feed_s_per_round": t_feed / rounds,
        "dispatch_s_per_round": step_s,
        "buf_len": pool.buf_len,
    }


def bench_fused(n_ch: int, rounds: int, log, device=None) -> dict:
    """FusedDevicePool with a measured line-item budget: every round is
    {1 chunk H2D, 1 round on the card, 1 packed D2H}; each item is measured
    on its own and their sum is checked against the measured wall time a
    round. fused_compute_msamples_per_s is the round's rate on a chunk
    already on the card (difference of chains, no per-round D2H), the
    number to compare with the receive alone at the same batch."""
    device = resolve_device(device)
    g = build_geometry(CFG)
    pool = serve.FusedDevicePool(g, n_ch, device=device)
    chunk, round_block, priming = _lockstep(g, pool, n_ch, device)

    t_prime = time.perf_counter()
    pool.round(priming())
    n_prime = len(pool.unpack(pool.round(round_block(0))))
    t_prime = time.perf_counter() - t_prime
    log(f"  priming: {n_prime}/{n_ch} decoded ({t_prime:.1f}s incl. "
        f"first-call set-up)")

    # measured end-to-end rounds, double-buffered. Blocks are built before
    # the timing: a deployment's serving loop receives sample blocks, it
    # does not synthesize them; their build time is its own line item
    t_b = time.perf_counter()
    blocks = [round_block(r) for r in range(1, rounds + 2)]
    t_build = (time.perf_counter() - t_b) / len(blocks)
    decoded = 0
    t_unpack = 0.0
    t0 = time.perf_counter()
    for r in range(1, rounds + 1):
        nxt = blocks[r] if r < rounds else None
        packed = pool.round(blocks[r - 1], next_block=nxt)
        t_u = time.perf_counter()
        decoded += len(pool.unpack(packed))
        t_unpack += time.perf_counter() - t_u
    wall = (time.perf_counter() - t0) / rounds
    t_unpack /= rounds

    # (a) dispatch round-trip floor: one tiny kernel and its D2H
    z1 = torch.zeros((1,), device=device)
    (z1 + 1.0).cpu()
    t_r = time.perf_counter()
    for _ in range(8):
        (z1 + 1.0).cpu()
    t_rtt = (time.perf_counter() - t_r) / 8
    # (b) the chunk's H2D, through the pools' pinned path, synchronized
    up = np.zeros((n_ch, chunk), np.float32)
    serve._to_device(up, device)
    bench.sync(device)
    t_h = time.perf_counter()
    for _ in range(3):
        serve._to_device(up, device)
        bench.sync(device)
    t_h2d = (time.perf_counter() - t_h) / 3
    # (c) the round on the card: difference of chains on a chunk already
    # there, a distinct input each round, a tiny D2H barrier
    chunk_dev = torch.from_numpy(round_block(1)).to(device)

    def chain(n: int) -> float:
        t0c = time.perf_counter()
        pk = None
        for i in range(n):
            pk = pool.round(chunk_dev + i * 1e-7)
        bench.sync(device)
        pk[:1, :4].cpu()
        return time.perf_counter() - t0c

    chain(1)
    reps = 3
    t_fused = max(chain(2 * reps) - chain(reps), 1e-9) / reps
    # (d) the packed D2H, of a ready result
    pk = pool.round(round_block(2))
    bench.sync(device)
    t_d = time.perf_counter()
    flat = pk.cpu().numpy()
    t_d2h = time.perf_counter() - t_d

    budget_sum = t_h2d + t_fused + t_d2h + t_unpack
    return {
        "pool": "fused",
        "n_channels": n_ch,
        "rounds": rounds,
        "chunk_samples_per_channel": chunk,
        "decoded_per_fed_frame": decoded / (n_ch * rounds),
        "wall_s_per_round": wall,
        "budget": {
            "h2d_chunk_s": t_h2d,
            "fused_dispatch_compute_s": t_fused,
            "d2h_packed_s": t_d2h,
            "dispatch_rtt_floor_s": t_rtt,
            "host_unpack_s": t_unpack,
            "block_build_s_excluded": t_build,
            "sum_s": budget_sum,
            "sum_vs_wall": budget_sum / max(wall, 1e-9),
            "h2d_bytes": int(up.nbytes),
            "d2h_bytes": int(flat.nbytes),
            "dispatches_per_round": 1,
        },
        "pool_ingest_msamples_per_s": n_ch * chunk / wall / 1e6,
        "pool_processed_msamples_per_s": n_ch * pool.buf_len / wall / 1e6,
        "fused_compute_msamples_per_s": n_ch * pool.buf_len / t_fused / 1e6,
        "realtime_channels": int(n_ch * chunk / wall / 48000),
        "buf_len": pool.buf_len,
    }


def bench_kernel(n_ch: int, log, device=None,
                 reps: int = bench.REPS) -> dict:
    """The receive alone at the same batch: CONFIG_9 frames of
    default_rng(7) payloads at 12 dB (bench.make_buffer; the JAX tool's
    point, while the pools' frames lie in 2e-3 noise), timed by
    bench.receive_rate."""
    device = resolve_device(device)
    g = build_geometry(CFG)
    rx = RxChain(g, device=device)
    payload = np.random.default_rng(7).integers(
        0, 256, (n_ch, g.frame_bytes)).astype(np.uint8)
    buf, _, _ = bench.make_buffer(g, device, 12.0, 1, batch=n_ch,
                                  payload=payload)
    rx.receive(buf)
    sps = bench.receive_rate(rx, buf, reps)
    log(f"  receive alone at batch {n_ch}: {sps / 1e6:.3f} Ms/s")
    return {"kernel_msamples_per_s": sps / 1e6}


def run(device, channels, rounds: int, pools, log) -> list[dict]:
    """Every pool at every channel count, each row beside the receive
    alone at its batch (pool_vs_kernel; fused also
    pool_vs_kernel_ex_transfer)."""
    results = []
    for n_ch in channels:
        kern = bench_kernel(n_ch, log, device)
        for kind in pools:
            log(f"=== {n_ch} channels ({kind} pool) ===")
            if kind == "fused":
                row = bench_fused(n_ch, rounds, log, device)
                row.update(kern)
                row["pool_vs_kernel_ex_transfer"] = (
                    row["fused_compute_msamples_per_s"]
                    / row["kernel_msamples_per_s"])
            else:
                row = bench_pool(n_ch, rounds, log, kind, device)
                row.update(kern)
            row["pool_vs_kernel"] = (row["pool_processed_msamples_per_s"]
                                     / row["kernel_msamples_per_s"])
            results.append(row)
            log(json.dumps(row))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mercury_tpu_torch.tools.serve_bench",
                                 description=__doc__)
    ap.add_argument("--channels", type=int, nargs="*",
                    default=[64, 256, 1024])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--pools", nargs="*", default=["fused", "device"],
                    choices=["fused", "device", "host"])
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = cli_device(args.cpu)
    if device is None:
        return 1
    results = run(device, args.channels, args.rounds, args.pools,
                  lambda m: print(m, flush=True))
    if args.out:
        meta = {**describe(device), "config": CFG,
                "rounds": args.rounds,
                "method": "lockstep rounds: feed -> gather -> H2D -> batched "
                          "receive -> D2H -> re-arm; kernel row: "
                          "bench.receive_rate on the same batch shape"}
        with open(args.out, "w") as f:
            json.dump({"meta": meta, "results": results}, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
