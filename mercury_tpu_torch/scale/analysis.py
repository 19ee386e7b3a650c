"""Scaling analysis of the sharded receive (PyTorch port of the JAX
package's `scale/analysis.py`): the analytic communication account of each
shard mode, the predicted efficiency at a stated link rate, and audits of
the transfers a sharded program made.

The JAX package audits the compiled HLO of its SPMD programs. The port's
programs are Python driving a list of devices, so its audits read the
program's transfer log instead (scale.shard: every copy between shards,
with its kind, bytes, source, destination, block and order of issue,
beside the schedule's "wait", "decode" and "decoded" events):

- logged_transfers: the count of each kind (the JAX hlo_collectives),
  those between processes apart; channel-parallel makes none;
- audit_overlap_structure: whether each halo of a block k+1 was issued
  before block k decoded and consumed only after it (the double buffer of
  time_sharded_receive_stream);

Over processes each rank keeps its own log: the transfers its shards send
and receive (a transfer between two ranks is in both logs, with the two
ranks and whether it went through host memory) and one "gather" entry a
call.
- scaling_structure_table: per mesh size, the channel-parallel transfers
  and the time-sharded bytes a shard receives per block against the
  account.

No link rate is assumed: the caller states it (a measured copy rate, a
data-sheet figure), and names its source.
"""

from __future__ import annotations

import numpy as np
import torch


def collective_account(geom, active_nsymb: int | None = None,
                       n_local: int | None = None) -> dict:
    """Analytic inter-device communication per shard mode, from the static
    shard geometry (all sizes in bytes, f32 samples).

    - channel-parallel RX: each device owns whole capture buffers; no
      stage mixes rows -> 0 bytes between devices per buffer.
    - time-sharded FIR: overlap-save halo of (taps-1) samples per shard
      per block, vs n_local samples of compute.
    - time-sharded RX: right halo of one frame + 2 symbols per shard per
      block, plus the seam dedupe (one claim flag + one delay).
    """
    nsymb = active_nsymb if active_nsymb is not None else geom.nsymb
    frame_interp = geom.nofdm * (nsymb + geom.preamble_nsymb) * geom.interp
    if n_local is None:
        n_local = geom.nofdm * geom.buffer_nsymb * geom.interp
    buf_bytes = 4 * n_local
    halo_rx = 4 * (frame_interp + 2 * geom.nofdm * geom.interp)
    taps = int(np.asarray(geom.fir_rx_data).shape[0])
    return {
        "channel_parallel": {
            "bytes_per_buffer": 0,
            "compute_bytes_per_buffer": buf_bytes,
            "comm_fraction": 0.0,
        },
        "time_sharded_fir": {
            "halo_bytes_per_shard_block": 4 * (taps - 1),
            "compute_bytes_per_shard_block": buf_bytes,
            "comm_fraction": round(4 * (taps - 1) / buf_bytes, 5),
        },
        "time_sharded_rx": {
            "halo_bytes_per_shard_block": halo_rx + 8,   # + dedupe flags
            "compute_bytes_per_shard_block": buf_bytes,
            "comm_fraction": round((halo_rx + 8) / buf_bytes, 4),
        },
    }


def predicted_efficiency(measured_msamples_per_s: float, geom,
                         active_nsymb: int | None = None, *,
                         link_bytes_per_s: float) -> dict:
    """Predicted 1-device -> multi-device efficiency per shard mode at the
    stated link rate (bytes/s, required), from the analytic account and a
    measured single-device rate.

    Serialized model: eff = t_compute / (t_compute + t_comm); with
    double-buffered overlap, eff = min(1, t_compute / t_comm), reported
    beside it so that the conservative number is the headline.
    """
    acc = collective_account(geom, active_nsymb)
    n_local = geom.nofdm * geom.buffer_nsymb * geom.interp
    t_compute = n_local / (measured_msamples_per_s * 1e6)   # s per block
    out = {"assumed_link_bytes_per_s": link_bytes_per_s,
           "measured_msamples_per_s": measured_msamples_per_s}
    for mode, a in acc.items():
        comm_bytes = a.get("halo_bytes_per_shard_block",
                           a.get("bytes_per_buffer", 0))
        t_comm = comm_bytes / link_bytes_per_s
        eff_serial = t_compute / (t_compute + t_comm)
        eff_overlap = 1.0 if t_comm <= t_compute else t_compute / t_comm
        out[mode] = {
            "comm_bytes_per_block": comm_bytes,
            "efficiency_serialized": round(eff_serial, 4),
            "efficiency_overlapped": round(eff_overlap, 4),
        }
    return out


def _log(program_or_log) -> list[dict]:
    return getattr(program_or_log, "log", program_or_log)


def logged_transfers(program_or_log) -> dict[str, int]:
    """The count of each kind of transfer between shards in a sharded
    program's last call (or a log): {} for channel-parallel. A transfer
    between shards of two processes counts under "<kind> across
    processes"; the gather is not a transfer between shards."""
    counts: dict[str, int] = {}
    for e in _log(program_or_log):
        if "src" in e:
            kind = e["kind"] + (" across processes" if "src_rank" in e
                                else "")
            counts[kind] = counts.get(kind, 0) + 1
    return counts


def audit_overlap_structure(program_or_log) -> dict:
    """Check from the log that the halo exchange of a block-pipelined
    receive can run under the decode. A halo of block k >= 1 (block 0's is
    the prologue) must be issued before block k-1's "decode" event (else
    the transfer starts only once that decode has been issued: its block is
    in blocking_upstream), and some decode must be issued between the
    transfer and the "wait" that consumes it (else the decode that reads it
    waits for the transfer: blocking_downstream). A halo this process sends
    to another is waited on in that process's log: here only its issue is
    checked.

    Returns {"overlap_scheduled": bool, "halo_bytes" (the largest halo),
    "halos_past_first_block", "transfers" (logged_transfers),
    "blocking_upstream", "blocking_downstream" (sorted blocks)}."""
    log = _log(program_or_log)
    decodes = {e["block"]: e["seq"] for e in log if e["kind"] == "decode"}
    halos = [e for e in log if e["kind"] == "halo"]
    later = [e for e in halos if e["block"] >= 1]
    if not later:
        return {"overlap_scheduled": False,
                "reason": "no halo past the first block"}
    waits = {}
    for e in log:
        if e["kind"] == "wait":
            waits.setdefault((e["block"], e["dst"]), e["seq"])
    up, down = set(), set()
    for e in later:
        k = e["block"]
        if e["seq"] > decodes.get(k - 1, -1):
            up.add(k)
        if "dst_rank" in e and (k, e["dst"]) not in waits:
            continue
        wait = waits.get((k, e["dst"]), e["seq"])
        if not any(e["seq"] < d < wait for d in decodes.values()):
            down.add(k)
    return {
        "overlap_scheduled": not up and not down,
        "halo_bytes": max(e["bytes"] for e in halos),
        "halos_past_first_block": len(later),
        "transfers": logged_transfers(log),
        "blocking_upstream": sorted(up),
        "blocking_downstream": sorted(down),
    }


def scaling_structure_table(rx_chain, device_counts=(2, 4, 8),
                            axis: str = "ch", device=None) -> list[dict]:
    """Per mesh size, from the transfer logs of one call each on one
    zero-filled row: the channel-parallel receive's transfers (claim: none
    at any size) and the time-sharded receive's bytes a shard receives per
    block, its largest halo plus its largest dedupe transfer (claim: the
    analytic halo account, independent of the size, while the compute a
    shard does stays n_local samples). device None: the first d cards (a
    count above the cards is skipped); a device: a virtual mesh on it."""
    from mercury_tpu_torch.scale import shard as shard_mod

    g = rx_chain.geom
    n_local = g.nofdm * g.buffer_nsymb * g.interp
    acc = collective_account(g, rx_chain.active_nsymb)
    rows = []
    for d in device_counts:
        if d < 2:
            continue
        if device is None:
            if d > torch.cuda.device_count():
                continue
            mesh = shard_mod.make_mesh(d, axis=axis)
        else:
            mesh = shard_mod.make_mesh(d, axis=axis, devices=[device] * d)
        dev0 = mesh.devices.flat[0]
        run_cp = shard_mod.channel_parallel_receive(rx_chain, mesh, axis=axis)
        run_cp(torch.zeros((d, n_local), device=dev0))
        run_ts = shard_mod.time_sharded_receive(rx_chain, mesh,
                                                time_axis=axis)
        run_ts(torch.zeros((1, d * n_local), device=dev0))
        biggest = {}
        for e in run_ts.log:
            if "bytes" in e:
                biggest[e["kind"]] = max(biggest.get(e["kind"], 0),
                                         e["bytes"])
        rows.append({
            "devices": d,
            "channel_parallel_transfers": logged_transfers(run_cp),
            "ts_transfer_bytes_per_device": sum(biggest.values()),
            "ts_analytic_halo_bytes_per_device":
                acc["time_sharded_rx"]["halo_bytes_per_shard_block"],
            "ts_compute_bytes_per_device":
                acc["time_sharded_rx"]["compute_bytes_per_shard_block"],
        })
    return rows
