"""Headline benchmark of the port: receive samples/s on one CUDA card
(full demod + LDPC decode; the counterpart of the repo root's bench.py).

    python -m mercury_tpu_torch.bench          # on the card
    python -m mercury_tpu_torch.bench --cpu    # the plain versions
    python -m mercury_tpu_torch -m BENCH [--cpu]

Runs the complete receive (mixer + FIR, sync, channel estimate, equalize,
demap, LDPC, CRC) on a batch of CONFIG_9 capture buffers and measures
passband samples processed per second. Prints ONE JSON line: the metric,
value, unit and vs_baseline, the backend ("torch-cuda" or "torch-cpu") and
the device's name, and a "scaling" block: the transfers of a 2-shard
channel-parallel receive (none), the time-sharded halo per block, the
predicted 2-device efficiencies at a link rate measured here (one halo
copied card to card, or within the one card; under a process group, one
halo from rank 0 to rank 1) and the transfer-log audit of the
double-buffered stream receive. Without a card and without --cpu it
exits 1; it never falls back to the CPU.

    torchrun --nproc-per-node 2 -m mercury_tpu_torch.bench

runs it under a process group (scale.dist): rank 0 measures and prints,
the other ranks only take part in the link rate.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.convert import cli_device, describe, resolve_device
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain
from mercury_tpu_torch.scale import analysis, dist, shard

CFG = 9            # QPSK 8/16, mid-ladder workhorse mode
BATCH = 256
REPS = 10
# vs_baseline's denominator: the reference C++ modem's receive_byte
# throughput on ONE CPU thread of the TPU host (tools/golden_gen rxbench 9,
# bench.py:26). A CPU figure for the ratio only, never a number of the card.
REFERENCE_CPU_SAMPLES_PER_S = 1.77e6
METRIC = "rx_demod_ldpc_samples_per_sec_per_chip"


def make_buffer(g, device, esn0: float, seed: int, ctrl: bool = False,
                fading: dict | None = None, batch: int = BATCH,
                payload=None):
    """batch frames in white noise at Es/N0 esn0, at bench.py's delay; an
    MFSK mode's at a symbol-aligned delay, esn0 then the channel SNR
    (sim.sigma_for_channel_snr). payload: [batch, frame_bytes] uint8 to
    send (numpy or a tensor), else random bytes drawn from the seeded
    generator before the noise. fading: Watterson parameters applied to the
    frames before the noise (host numpy, seed 42). -> (buffer [batch,
    buf_len] float32, payload uint8 tensor, delay), all on device."""
    device = torch.device(device)
    tx = TxChain(g, device=device, ctrl=ctrl)
    gen = torch.Generator(device=device).manual_seed(seed)
    if payload is None:
        payload = torch.randint(0, 256, (batch, g.frame_bytes), generator=gen,
                                device=device, dtype=torch.uint8)
    else:
        payload = torch.as_tensor(payload, dtype=torch.uint8, device=device)
    buf_len = g.nofdm * g.buffer_nsymb * g.interp
    frames = tx.transmit(payload)
    if g.spec.is_mfsk:
        delay = (g.preamble_nsymb + 2) * g.nofdm * g.interp
        sigma = sim.sigma_for_channel_snr(frames[0], esn0, g.fs, g.bandwidth)
    else:
        delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
        sigma = sim.sigma_for_esn0(esn0)
    if fading is not None:
        frames = torch.as_tensor(sim.watterson(frames, fs=g.fs, seed=42,
                                               **fading),
                                 dtype=torch.float32, device=device)
    buf = sim.awgn_passband(frames, sigma, delay, buf_len, gen)
    return buf, payload, delay


def bench_buffer(g, device, batch: int = BATCH, seed: int = 1,
                 payload_seed: int = 0):
    """bench.py's capture: payload np.random.default_rng(payload_seed)
    bytes, Es/N0 12 dB. The noise comes from a torch generator seeded
    `seed`: the JAX bench draws it from jax.random.key(1), which torch
    cannot reproduce, so the two benches see the same frames in different
    noise of the same power."""
    payload = np.random.default_rng(payload_seed).integers(
        0, 256, (batch, g.frame_bytes)).astype(np.uint8)
    return make_buffer(g, device, 12.0, seed, batch=batch, payload=payload)


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def receive_rate(rx: RxChain, buf: torch.Tensor, reps: int) -> float:
    """Receive samples/s of rx on buf, bench.py's method: chains of reps
    and 2 reps receives, each rep on a distinct input (buf + seq * 1e-7,
    far below the noise), each chain ending in a synchronize and a small
    D2H copy; the difference of the two chains is reps real calls, so
    the barrier and dispatch costs cancel."""
    seq = [0]

    def run_chain(n: int) -> float:
        t0 = time.perf_counter()
        r = None
        for _ in range(n):
            seq[0] += 1
            r = rx.receive(buf + seq[0] * 1e-7)
        sync(rx.device)
        r.payload[:1, :4].cpu()
        return time.perf_counter() - t0

    run_chain(1)                                # warm the perturbed path
    t_n = run_chain(reps)
    t_2n = run_chain(2 * reps)
    dt = max(t_2n - t_n, 1e-9)
    return buf.shape[0] * buf.shape[1] * reps / dt


def worker(device, batch: int = BATCH, reps: int = REPS) -> dict:
    """One warm-up receive of the bench buffer (its decoded rows counted,
    as bench.py does), then receive_rate. -> {"samples_per_s", "decoded",
    "batch", and the chain and buffer: "rx", "buf"}."""
    device = resolve_device(device)
    g = build_geometry(CFG)
    rx = RxChain(g, device=device)
    buf, _payload, _delay = bench_buffer(g, device, batch)
    res = rx.receive(buf)
    n_ok = int(res.crc_ok.sum())
    if n_ok < batch:
        print(f"warning: only {n_ok}/{batch} decoded in warmup",
              file=sys.stderr)
    return {"samples_per_s": receive_rate(rx, buf, reps), "decoded": n_ok,
            "batch": batch, "rx": rx, "buf": buf}


def audit(device) -> dict:
    """bench.py's audit_worker on the port: CONFIG_16, K = 2 blocks of the
    standard buffer a shard, one zero row, through
    time_sharded_receive_stream on a virtual 2-shard mesh of `device`;
    scale.analysis.audit_overlap_structure of its transfer log."""
    device = resolve_device(device)
    g = build_geometry(16, with_pre_eq=False)   # smallest frame geometry
    rx = RxChain(g, device=device)
    n_dev, k_blocks = 2, 2
    mesh = shard.make_mesh(n_dev, axis="t", devices=[device] * n_dev)
    n_local = g.nofdm * g.buffer_nsymb * g.interp
    run = shard.time_sharded_receive_stream(rx, mesh, n_blocks=k_blocks,
                                            time_axis="t")
    run(torch.zeros((1, k_blocks, n_dev * n_local), device=device))
    return analysis.audit_overlap_structure(run)


def link_rate(device, nbytes: int, reps: int = 15,
              group: dist.Group | None = None) -> tuple[float, str]:
    """Bytes/s of one device-to-device copy of nbytes, the median of reps:
    card 0 to card 1 where there are two cards ("peer"), else within the
    one card ("same card"), timed with CUDA events; on the CPU a copy in
    host memory on the host clock ("host memory"). With a process group,
    every rank calls it: a transfer from rank 0 to rank 1 over the group
    ("process"; scale.dist.transfer_rate)."""
    if group is not None:
        return dist.transfer_rate(group, device, nbytes, reps), "process"
    n = max(nbytes // 4, 1)
    if device.type != "cuda":
        src, dst = torch.zeros(n), torch.empty(n)
        times = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            dst.copy_(src)
            times.append(time.perf_counter() - t0)
        return 4 * n / statistics.median(times[1:]), "host memory"
    peer = torch.cuda.device_count() >= 2
    src = torch.zeros(n, device="cuda:0")
    dst = torch.empty(n, device="cuda:1" if peer else "cuda:0")
    times = []
    with torch.cuda.device(0):
        dst.copy_(src)
        torch.cuda.synchronize()
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
    return 4 * n / statistics.median(times), "peer" if peer else "same card"


def halo_bytes(g) -> int:
    """The time-sharded receive's bytes a shard receives per block."""
    return analysis.collective_account(g)["time_sharded_rx"][
        "halo_bytes_per_shard_block"]


def scaling(device, msamples_per_s: float, rx: RxChain,
            buf: torch.Tensor, group: dist.Group | None = None) -> dict:
    """bench.py's "scaling" block from this machine: the transfers of a
    2-shard channel_parallel_receive of buf's first two rows (none is
    allowed), the analytic time-sharded halo, the predicted efficiencies
    at a link rate measured here (between processes with a group), and
    the overlap audit."""
    mesh = shard.make_mesh(2, devices=[device] * 2)
    run_cp = shard.channel_parallel_receive(rx, mesh)
    run_cp(buf[:2])
    moved = analysis.logged_transfers(run_cp)
    if moved:
        raise RuntimeError(f"channel-parallel receive moved data: {moved}")
    g = rx.geom
    rate, link = link_rate(device, halo_bytes(g), group=group)
    pred = analysis.predicted_efficiency(msamples_per_s, g,
                                         link_bytes_per_s=rate)
    rep = audit(device)
    ts = pred["time_sharded_rx"]
    return {
        "channel_parallel_collective_bytes": sum(
            e["bytes"] for e in run_cp.log if "bytes" in e),
        "channel_parallel_2host_efficiency":
            pred["channel_parallel"]["efficiency_serialized"],
        "time_sharded_halo_bytes_per_block": ts["comm_bytes_per_block"],
        "time_sharded_2host_eff_serialized_measured_link":
            ts["efficiency_serialized"],
        "time_sharded_2host_eff_overlapped_measured_link":
            ts["efficiency_overlapped"],
        "link_bytes_per_s": rate,
        "link": link,
        "time_sharded_overlap_scheduled": bool(rep.get("overlap_scheduled")),
        "overlap_evidence": (
            "scale/shard.py:time_sharded_receive_stream double-buffered "
            "halo copies; transfer-log audit scale/analysis.py:"
            "audit_overlap_structure (largest halo "
            f"{rep.get('halo_bytes')} B, {rep.get('halos_past_first_block')}"
            " halos issued before the previous block's decode and waited on "
            f"after it; transfers {rep.get('transfers')})"),
    }


def main(argv=None, *, batch: int = BATCH, reps: int = REPS) -> int:
    """Print the benchmark's JSON line; 1 without a card and --cpu.
    batch and reps are for tests; the command line keeps the defaults.
    Started as a rank (torchrun), it brings up the process group on its
    rank's card (scale.dist.init; the CPU with --cpu) and names the
    group's backend on stderr."""
    ap = argparse.ArgumentParser(prog="mercury_tpu_torch.bench",
                                 description=__doc__)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = cli_device(args.cpu)
    if device is None:
        return 1
    group = None
    if dist.launched():
        group = dist.init(devices=["cpu"] if args.cpu else None)
        device = group.devices[0]
        # one write, so that the ranks' lines do not interleave
        sys.stderr.write(group.describe() + "\n")
        sys.stderr.flush()
    try:
        if group is not None and group.rank != 0:
            link_rate(device, halo_bytes(build_geometry(CFG)), group=group)
            return 0
        w = worker(device, batch, reps)
        sps = w["samples_per_s"]
        print(json.dumps({
            "metric": METRIC,
            "value": sps / 1e6,
            "unit": "Msamples/s",
            "vs_baseline": sps / REFERENCE_CPU_SAMPLES_PER_S,
            "platform": "gpu" if device.type == "cuda" else "cpu",
            **describe(device),
            "warmup_decoded": w["decoded"],
            "scaling": scaling(device, sps / 1e6, w["rx"], w["buf"], group),
        }))
        return 0
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
