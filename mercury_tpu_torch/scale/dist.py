"""Process groups for meshes that span processes: the port's counterpart of
JAX's multi-controller runtime, where a process stands for a host (or a
controller) and drives the shards of a mesh that are its own.

    # under torchrun (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT):
    group = dist.init()
    mesh = shard.make_mesh_2d(2, 2, ("dcn", "t"), group=group)
    run = shard.time_sharded_receive(rx, mesh, time_axis="t",
                                     batch_axis="dcn")
    res = run(pb)            # every rank passes the whole batch

    torchrun --nproc-per-node 2 -m mercury_tpu_torch.scale.dist \\
        my_script.py:main    # main(group) on every rank

Backend rule, a choice made from the layout (every rank's cards, gathered
at start over a gloo group):

- NCCL where every rank owns cards and no other rank owns the same card;
- gloo where ranks share a card, and on the CPU. gloo carries CPU tensors:
  a CUDA tensor that crosses processes is staged through host memory (a
  copy to the host behind its stream, the transfer, a copy to the card on
  the receiver's copy stream), and the transfer log says so ("staged").

NCCL refuses two ranks on one card, so a one-card machine runs its ranks
over gloo. If the chosen backend fails, init raises; nothing falls back.
Object gathers (the mesh layout) and barriers run on the gloo group in
either case.

launch() starts N ranks as subprocesses with torchrun's environment
contract (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE) and a file store
for the rendezvous (MERCURY_INIT_METHOD), and joins them under a timeout,
so a hung rendezvous fails rather than waits. This module's command line
is the rank program: it brings up the group, calls FILE:FUNCTION(group)
and saves what it returns (run_ranks reads it back).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import importlib.util
import logging
import os
import pathlib
import socket
import statistics
import subprocess
import sys
import time

import torch
import torch.distributed as tdist

log = logging.getLogger(__name__)

# the repo root: a rank program imports the package from there
ROOT = pathlib.Path(__file__).resolve().parents[2]
# how long a collective or a transfer may wait for its peer
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the group: its rank, the world size, the
    devices it owns, and the data plane's backend ("nccl" or "gloo") and
    process group (None: the default group)."""
    rank: int
    world_size: int
    devices: tuple[torch.device, ...]
    backend: str
    pg: object = None

    def staged(self, *devices: torch.device) -> bool:
        """Whether a transfer between these devices goes through host
        memory: a CUDA tensor over gloo."""
        return self.backend == "gloo" and any(d.type == "cuda"
                                              for d in devices)

    def describe(self) -> str:
        text = f"rank {self.rank} of {self.world_size} on " + ", ".join(
            map(str, self.devices)) + f": {self.backend}"
        if self.staged(*self.devices):
            text += (" (CUDA tensors cross processes through host memory: "
                     "ranks share a card or own none)")
        return text


def launched() -> bool:
    """Whether this process was started as a rank (torchrun's contract)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def choose_backend(cards: list[list[str]]) -> str:
    """The data plane from every rank's cards (identifiers, one list a
    rank): NCCL when each rank owns at least one card and no card is owned
    by two ranks, else gloo."""
    seen = [c for rank_cards in cards for c in set(rank_cards)]
    if all(cards) and len(seen) == len(set(seen)):
        return "nccl"
    return "gloo"


def _card(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    return str(getattr(props, "uuid", f"{socket.gethostname()}:"
                                      f"{device.index}"))


def _local_devices(devices, local_rank: int) -> tuple[torch.device, ...]:
    """`devices`, a CUDA device without an index taken as this rank's
    card; by default this rank's card alone."""
    if devices is None:
        devices = ["cuda"]
    devices = [torch.device(d) for d in devices]
    if any(d.type == "cuda" for d in devices) and not \
            torch.cuda.is_available():
        raise RuntimeError(
            "a rank takes a CUDA card unless given devices, and none is "
            "available; pass devices=['cpu'] (device='cpu' runs the plain "
            "versions)")
    return tuple(torch.device("cuda",
                              local_rank % torch.cuda.device_count())
                 if d.type == "cuda" and d.index is None else d
                 for d in devices)


def init(rank: int | None = None, world_size: int | None = None,
         init_method: str | None = None, devices=None) -> Group:
    """Bring up torch.distributed and choose the data plane (the module's
    backend rule). rank, world_size: from RANK and WORLD_SIZE unless given;
    init_method: MERCURY_INIT_METHOD (launch's file store), else "env://"
    (MASTER_ADDR, MASTER_PORT); devices: this process's devices, by default
    the card LOCAL_RANK modulo the cards (ranks share cards when there are
    fewer than ranks; without a card this raises; "cuda" without an index
    means that card too). Where every rank runs on this host
    (LOCAL_WORLD_SIZE = WORLD_SIZE), gloo goes over the loopback unless
    GLOO_SOCKET_IFNAME says otherwise. -> Group."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    if init_method is None:
        init_method = env.get("MERCURY_INIT_METHOD", "env://")
    if env.get("LOCAL_WORLD_SIZE") == str(world_size):
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    devs = _local_devices(devices, int(env.get("LOCAL_RANK", rank)))
    cuda = [d for d in devs if d.type == "cuda"]
    if cuda:
        torch.cuda.set_device(cuda[0])
    tdist.init_process_group("gloo", init_method=init_method, rank=rank,
                             world_size=world_size, timeout=TIMEOUT)
    cards = [None] * world_size
    tdist.all_gather_object(cards, sorted({_card(d) for d in cuda}))
    backend = choose_backend(cards)
    pg = (tdist.new_group(backend="nccl", timeout=TIMEOUT)
          if backend == "nccl" else None)
    group = Group(rank, world_size, devs, backend, pg)
    log.info(group.describe())
    return group


def post_send(group: Group, t: torch.Tensor, peer: int, tag: int, stream):
    """Post t (made on `stream`, None on the CPU) to rank peer. gloo takes
    a CUDA tensor from host memory, copied behind the stream's work; NCCL
    sends from the card after the stream's work. -> (the work, what must
    stay alive until it completes)."""
    with torch.cuda.stream(stream):
        if group.staged(t.device):
            t = t.to("cpu")
        return tdist.isend(t, peer, group=group.pg, tag=tag), t


class Received:
    """A posted receive of a tensor from another rank into `device`.
    wait() -> (the tensor on the device, the event after which it may be
    read on the card, None on the CPU), the card's copies on `stream` (the
    destination's copy stream)."""

    def __init__(self, group: Group, shape, dtype, peer: int, tag: int,
                 device: torch.device, stream):
        self.device, self.stream = device, stream
        self.staged = group.staged(device)
        if self.staged or stream is None:
            self.buf = torch.empty(shape, dtype=dtype)
            self.work = tdist.irecv(self.buf, peer, group=group.pg, tag=tag)
            return
        with torch.cuda.stream(stream):
            self.buf = torch.empty(shape, dtype=dtype, device=device)
            self.work = tdist.irecv(self.buf, peer, group=group.pg, tag=tag)

    def wait(self):
        if self.stream is None:
            self.work.wait()
            return self.buf, None
        with torch.cuda.stream(self.stream):
            self.work.wait()
            out = self.buf.to(self.device) if self.staged else self.buf
            return out, self.stream.record_event()


def all_gather_bytes(group: Group, t: torch.Tensor) -> list[torch.Tensor]:
    """A flat uint8 tensor of the same size on every rank -> every rank's,
    in rank order, on t's device (through host memory where gloo carries a
    CUDA tensor)."""
    src = t.cpu() if group.staged(t.device) else t
    out = [torch.empty_like(src) for _ in range(group.world_size)]
    tdist.all_gather(out, src, group=group.pg)
    return [o.to(t.device) for o in out]


def transfer_rate(group: Group, device: torch.device, nbytes: int,
                  reps: int = 15) -> float:
    """Bytes/s of one transfer of nbytes between rank 0 and rank 1 over
    the data plane: each repetition a round trip 0 -> 1 -> 0 on rank 0's
    host clock (ending in a synchronize on a card), halved; the median of
    reps after one warm-up, as rank 0 measured it, on every rank. Where
    gloo carries CUDA tensors the copies through host memory are in it."""
    n = max(nbytes // 4, 1)
    t = torch.zeros(n, device=device)
    stream = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)
    times = []
    if group.rank < 2:
        peer = 1 - group.rank
        for i in range(reps + 1):
            t0 = time.perf_counter()
            if group.rank == 0:
                post_send(group, t, peer, 2 * i, stream)[0].wait()
                got, done = Received(group, t.shape, t.dtype, peer,
                                     2 * i + 1, device, stream).wait()
                if done is not None:
                    done.synchronize()
            else:
                got, _done = Received(group, t.shape, t.dtype, peer, 2 * i,
                                      device, stream).wait()
                post_send(group, got, peer, 2 * i + 1, stream)[0].wait()
            times.append(time.perf_counter() - t0)
    rate = [4 * n / (statistics.median(times[1:]) / 2)
            if group.rank == 0 else None]
    tdist.broadcast_object_list(rate, src=0)
    return rate[0]


def launch(argv: list[str], n_ranks: int, workdir, *,
           timeout: float = 600.0) -> list[str]:
    """Run `python *argv` as n_ranks processes from the repo root with
    torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE),
    one torch thread each (OMP_NUM_THREADS=1) and a file store in workdir
    for the
    rendezvous (MERCURY_INIT_METHOD); wait for all within timeout
    seconds. -> each rank's output (stdout and stderr, also in
    workdir/rank<r>.log). RuntimeError, with the end of every rank's
    output, as soon as a rank exits with an error or the time is up; every
    rank still running is then killed."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "store"
    store.unlink(missing_ok=True)
    logs = [workdir / f"rank{r}.log" for r in range(n_ranks)]
    procs = []
    try:
        for r in range(n_ranks):
            env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(n_ranks),
                   "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(n_ranks),
                   "MERCURY_INIT_METHOD": store.as_uri(),
                   "OMP_NUM_THREADS": "1"}
            with open(logs[r], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, *argv], cwd=ROOT, env=env, stdout=out,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                break
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or time.monotonic() > deadline:
                why = (f"rank {failed[0]} exited with {codes[failed[0]]}"
                       if failed else f"not done after {timeout:g} s")
                raise RuntimeError(f"{n_ranks} ranks of {argv}: {why}\n" +
                                   "\n".join(f"--- rank {r}:\n"
                                             f"{p.read_text()[-3000:]}"
                                             for r, p in enumerate(logs)))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [p.read_text() for p in logs]


def run_ranks(target: str, n_ranks: int, workdir, *, devices=None,
              timeout: float = 600.0) -> tuple[list, list]:
    """launch() the rank program on target ("path/to/file.py:function",
    relative to the repo root or absolute):
    every rank calls function(group) on `devices` (a list given to init on
    every rank; None: its card). -> (what each rank's function returned,
    each rank's output), in rank order."""
    workdir = pathlib.Path(workdir).resolve()
    argv = ["-m", __name__, target, "--out", str(workdir)]
    if devices is not None:
        argv += ["--devices", ",".join(map(str, devices))]
    logs = launch(argv, n_ranks, workdir, timeout=timeout)
    results = [torch.load(workdir / f"rank{r}.pt", weights_only=True)
               for r in range(n_ranks)]
    return results, logs


def _load(target: str):
    path, _, name = target.rpartition(":")
    spec = importlib.util.spec_from_file_location(
        pathlib.Path(path).stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mercury_tpu_torch.scale.dist",
        description="The rank program: init() (torchrun's environment, or "
                    "launch's), then FILE:FUNCTION(group) on every "
                    "rank.")
    ap.add_argument("target", help="path/to/file.py:function")
    ap.add_argument("--out", help="directory for rank<r>.pt, the "
                                  "function's result (torch.save)")
    ap.add_argument("--devices", help="this rank's devices, e.g. cpu,cpu "
                                      "(default: its card)")
    args = ap.parse_args(argv)
    group = init(devices=args.devices.split(",") if args.devices else None)
    print(group.describe(), flush=True)
    try:
        result = _load(args.target)(group)
        if args.out:
            torch.save(result, pathlib.Path(args.out) / f"rank{group.rank}.pt")
    finally:
        tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
