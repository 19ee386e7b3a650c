"""The rank side of tests/test_torch_dist.py: functions that
mercury_tpu_torch.scale.dist runs on every rank of a CPU process group
(scale.dist.run_ranks), and the numpy inputs both sides build. It holds
no test of its own. It imports neither JAX nor mercury_tpu, as a rank
program on the card's machine must not (tests/test_torch_package.py
holds it so)."""

import dataclasses

import numpy as np
import torch

from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.modem.rx import RxChain, RxResult
from mercury_tpu_torch.modem.tx import TxChain
from mercury_tpu_torch.scale import dist, shard


def frames(g, n: int, seed: int):
    """n random payloads (default_rng(seed)) and their frames -> (payload
    uint8 [n, frame_bytes], frames float32 [n, frame_len], the generator
    for what comes next)."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (n, g.frame_bytes)).astype(np.uint8)
    fr = TxChain(g, device="cpu").transmit(torch.as_tensor(payload))
    return payload, fr.numpy(), rng


def stream_2d(g):
    """Two streams of 2 slices of the standard buffer (tests/
    test_torch_shard.py's 2-D case, default_rng(11)): row 0 a frame mid
    slice 0 and one mid slice 1, row 1 one 8 samples before the seam,
    which both slices decode and the left one claims. -> (x [2, 2 n],
    {(slice, row): (start, payload)})."""
    n = g.nofdm * g.buffer_nsymb * g.interp
    plan = {(0, 0): 2000, (1, 0): n + 9000, (0, 1): n - 8}
    payload, fr, rng = frames(g, len(plan), 11)
    x = (0.002 * rng.standard_normal((2, 2 * n))).astype(np.float32)
    want = {}
    for i, ((j, r), start) in enumerate(plan.items()):
        x[r, start: start + fr.shape[1]] += fr[i]
        want[j, r] = (start, payload[i])
    return x, want


def stream_blocks(g):
    """Two streams of K = 2 blocks of 2 slices (default_rng(12)): row 0 a
    frame in slice 0, one straddling the block seam (slice 1's, completed
    from block 1's head) and one in slice 3; row 1 one 8 samples before the
    block seam (slice 1's; slice 2 decodes it too and drops it) and one in
    slice 3. -> (x [2, 2, 2 n], {(slice, row): (start, payload)})."""
    n = g.nofdm * g.buffer_nsymb * g.interp
    fl = g.nofdm * (g.nsymb + g.preamble_nsymb) * g.interp
    plan = {(0, 0): 3000, (1, 0): 2 * n - fl // 3, (3, 0): 3 * n + 20000,
            (1, 1): 2 * n - 8, (3, 1): 3 * n + 9000}
    payload, fr, rng = frames(g, len(plan), 12)
    x = (0.002 * rng.standard_normal((2, 4 * n))).astype(np.float32)
    want = {}
    for i, ((j, r), start) in enumerate(plan.items()):
        x[r, start: start + fr.shape[1]] += fr[i]
        want[j, r] = (start, payload[i])
    return x.reshape(2, 2, 2 * n), want


def channels(g):
    """Four CONFIG_9 buffers at Es/N0 12 dB (default_rng(13)), a frame
    each at 3000 + 411 r. -> (buf [4, n], payload [4, frame_bytes])."""
    n = g.nofdm * g.buffer_nsymb * g.interp
    payload, fr, rng = frames(g, 4, 13)
    buf = (rng.standard_normal((4, n)) * sim.sigma_for_esn0(12.0)
           ).astype(np.float32)
    for r in range(4):
        d = 3000 + 411 * r
        buf[r, d: d + fr.shape[1]] += fr[r]
    return buf, payload


def fir_input():
    g = build_geometry(0, with_pre_eq=False)
    x = np.random.default_rng(3).standard_normal((2, 4 * 4096))
    return x.astype(np.float32), g.fir_rx_data.astype(np.float32)


def fields(res: RxResult) -> dict:
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}


def _error(make) -> str:
    """The message of the ValueError make() raises ("" if none)."""
    try:
        make()
    except ValueError as e:
        return str(e)
    return ""


def forms(group: dist.Group) -> dict:
    """Every multi-process form on two CPU ranks: (a) CONFIG_16 on a 2 x 2
    (dcn, t) mesh, dcn across the ranks; (b) the time axis across the
    ranks, one shard each, as time_sharded_receive and as the stream form
    over K = 2 blocks; (c) CONFIG_9 channel-parallel over 4 shards, 2 a
    rank; time_sharded_fir over 4 shards, 2 a rank; (d) the layouts that
    cannot be laid; the process-to-process link rate. -> results, logs and
    error messages."""
    cpu = torch.device("cpu")
    g16 = build_geometry(16)
    rx16 = RxChain(g16, device="cpu")
    out = {}

    x, _ = stream_2d(g16)
    mesh = shard.make_mesh_2d(2, 2, axes=("dcn", "t"), devices=["cpu"] * 2,
                              group=group)
    run = shard.time_sharded_receive(rx16, mesh, time_axis="t",
                                     batch_axis="dcn")
    out["a"] = {"res": fields(run(torch.as_tensor(x))), "log": run.log,
                "ranks": mesh.ranks.tolist()}

    mesh = shard.make_mesh(2, axis="t", devices=["cpu"], group=group)
    run = shard.time_sharded_receive(rx16, mesh)
    out["b"] = {"res": fields(run(torch.as_tensor(x))), "log": run.log}

    xs, _ = stream_blocks(g16)
    run = shard.time_sharded_receive_stream(rx16, mesh, n_blocks=2)
    out["stream"] = {"res": fields(run(torch.as_tensor(xs))),
                     "log": run.log}

    g9 = build_geometry(9)
    buf, _ = channels(g9)
    mesh = shard.make_mesh(4, devices=["cpu"] * 2, group=group)
    run = shard.channel_parallel_receive(RxChain(g9, device="cpu"), mesh)
    out["c"] = {"res": fields(run(torch.as_tensor(buf))), "log": run.log}

    xf, taps = fir_input()
    f = shard.time_sharded_fir(shard.make_mesh(4, axis="t",
                                               devices=["cpu"] * 2,
                                               group=group), taps)
    out["fir"] = {"y": f(torch.as_tensor(xf)), "log": f.log}

    out["d"] = {
        "n over ranks": _error(lambda: shard.make_mesh(
            3, devices=["cpu"] * 3, group=group)),
        "outer over ranks": _error(lambda: shard.make_mesh_2d(
            3, 1, devices=["cpu"] * 3, group=group)),
        "too few devices": _error(lambda: shard.make_mesh_2d(
            2, 2, devices=["cpu"], group=group)),
        # one rank short: both ranks raise, neither waits on the other
        "one rank short": _error(lambda: shard.make_mesh(
            4, devices=["cpu"] * (2 - group.rank), group=group)),
        # a program over the inner axis of a (dcn, t) mesh: rank 0's
        # devices alone; both ranks raise
        "inner axis only": _error(lambda: shard.time_sharded_fir(
            shard.make_mesh_2d(2, 2, axes=("dcn", "t"), devices=["cpu"] * 2,
                               group=group), taps)),
    }
    out["rate"] = dist.transfer_rate(group, cpu, 4096)
    return out


def fail_on_rank_1(group: dist.Group) -> dict:
    """Rank 1 raises while rank 0 waits for it in a barrier."""
    if group.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()
    return {}
