"""Multi-device receive: channel-parallel and time-sharded (PyTorch port of
the JAX package's `scale/shard.py`).

One process drives an explicit list of devices, as one JAX controller
drives the local devices of a shard_map. A `Mesh` is a numpy array of
`torch.device`s with axis names; a device may repeat, which makes a
virtual mesh (four shards all on cuda:0, as the JAX tests' 8-device CPU
mesh), and on a host with several cards the same code copies between
them. Two axes:

- **channels**: independent capture buffers, data-parallel, with no bytes
  moved between shards (channel_parallel_receive);
- **time**: one long capture stream split across shards; each extends its
  slice with a right halo (one frame + 2 symbols) copied from its right
  neighbour, receives with sync_limit = its slice length, and claims only
  the frames that start in its slice (time_sharded_receive, the
  block-pipelined time_sharded_receive_stream, and the overlap-save
  time_sharded_fir).

Every shard has a chain of its own (RxChain.replica on its device) and,
on a card, a CUDA stream of its own. The calling thread drives the shards
in turn; a receive reads results on the host when it decodes failed rows
again (the recovery's BICM-ID, DD or MFSK runner-up, CONFIG_0's rescue),
so on one card the shards' receives follow one another, while the halo
copies run under them on a copy stream. A tensor that crosses
streams is handed over with an event wait and record_stream. Neighbour
copies take the place of ppermute: a copy into a fresh tensor on the
destination's copy stream, behind an event (a real copy also when both
shards share a card). Every such transfer is logged in the program's
`log` with its kind ("halo" or "dedupe"), bytes, source and destination
shards, block and order of issue, beside the schedule's "wait" (a shard's
stream waits for its halo) and "decode"/"decoded" events; scale.analysis
reads the log where the JAX package reads the compiled HLO.

The returned programs gather their outputs onto the first shard's device,
as reading a sharded jax.Array gathers it; that gather is not an exchange
between shards and is not logged.

A mesh may span processes (make_mesh/make_mesh_2d with a scale.dist
group, one process a host, as JAX's multi-controller runtime): each entry
then has the rank that drives it, the inner axis of a 2-D mesh stays
within one rank and the outer one runs across ranks, as JAX's hybrid
layout lays it over slices. The programs are called alike on every rank
with the whole batch; each rank moves only its own slices to its devices
and builds and drives only its own shards, in the mesh's order. A
transfer between shards of two ranks is an isend/irecv pair over the
group (posted on both sides in the same order, the mesh's), logged on
both ranks with the two ranks and whether it was staged through host
memory; the gather is an all_gather over the group, so that every rank
returns the whole result in mesh order, and is logged as one "gather"
entry with the bytes this rank put in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from mercury_tpu_torch.dsp import ops
from mercury_tpu_torch.modem.rx import RxChain, RxResult
from mercury_tpu_torch.scale import dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """devices: a numpy object array of torch.device, one axis per name;
    ranks: the process that drives each entry (int, the devices' shape;
    all 0 in one process); group: the scale.dist group of a mesh over
    processes (None: this process alone)."""
    devices: np.ndarray
    axis_names: tuple[str, ...]
    ranks: np.ndarray | None = None
    group: dist.Group | None = None

    def __post_init__(self):
        if self.ranks is None:
            object.__setattr__(self, "ranks",
                               np.zeros(self.devices.shape, dtype=np.int64))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def rank(self) -> int:
        """This process's rank in the mesh's group (0 in one process)."""
        return 0 if self.group is None else self.group.rank

    def _along(self, arr: np.ndarray, axis: str, index: int) -> list:
        a = self.axis_names.index(axis)
        return list(np.moveaxis(arr, a, -1).reshape(-1, arr.shape[a])[index])

    def axis_devices(self, axis: str, index: int = 0) -> list[torch.device]:
        """The devices along `axis`, at `index` of the other axis (if any)."""
        return self._along(self.devices, axis, index)

    def axis_ranks(self, axis: str, index: int = 0) -> list[int]:
        """The ranks driving the entries of axis_devices(axis, index)."""
        return [int(r) for r in self._along(self.ranks, axis, index)]


def _device_list(n: int | None, devices) -> list[torch.device]:
    """`devices` (the first n), or the first n CUDA cards; raise without
    enough."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh takes the CUDA cards unless given devices, and none "
                "is available; pass devices=['cpu'] * n (device='cpu' runs "
                "the plain versions)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    n = len(devices) if n is None else n
    if n > len(devices):
        raise ValueError(f"a mesh of {n} needs more than the "
                         f"{len(devices)} available devices")
    return devices[:n]


def _over_ranks(n: int, devices, group: dist.Group) -> tuple[list, list]:
    """n entries, n / world_size from each rank in rank order: this rank's
    first ones of `devices` (its group's devices by default), gathered over
    the group. -> (devices, ranks). ValueError on every rank (before any
    rank waits on another) if n does not divide over the ranks or a rank
    has too few devices."""
    if n % group.world_size:
        raise ValueError(f"a mesh of {n} does not divide over "
                         f"{group.world_size} processes")
    k = n // group.world_size
    local = _device_list(None, group.devices if devices is None
                         else devices)
    every = [None] * group.world_size
    torch.distributed.all_gather_object(every, [str(d) for d in local])
    short = [r for r, devs in enumerate(every) if len(devs) < k]
    if short:
        raise ValueError(f"a mesh of {n} over {group.world_size} processes "
                         f"needs {k} devices a process; process {short[0]} "
                         f"has {len(every[short[0]])}")
    return ([torch.device(d) for devs in every for d in devs[:k]],
            [r for r in range(group.world_size) for _ in range(k)])


def _mesh(devs: list[torch.device], shape, axes, ranks=None,
          group=None) -> Mesh:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    if ranks is not None:
        ranks = np.asarray(ranks, dtype=np.int64).reshape(shape)
    return Mesh(arr.reshape(shape), tuple(axes), ranks, group)


def make_mesh(n_devices: int | None = None, axis: str = "ch",
              devices=None, group: dist.Group | None = None) -> Mesh:
    """A 1-D mesh of the first n_devices CUDA cards (all of them by
    default; ValueError if there are fewer), or of the first n_devices of
    `devices`, which may repeat a device (a virtual mesh). With a group:
    n_devices / world_size entries from each rank, in rank order, from
    its `devices` (the group's by default); the axis runs across ranks
    (the time axis over two hosts, whose halos then cross processes)."""
    if group is None:
        devs = _device_list(n_devices, devices)
        return _mesh(devs, (len(devs),), (axis,))
    devs, ranks = _over_ranks(n_devices, devices, group)
    return _mesh(devs, (n_devices,), (axis,), ranks, group)


def make_mesh_2d(n_outer: int, n_inner: int,
                 axes: tuple[str, str] = ("dcn", "ch"), devices=None,
                 group: dist.Group | None = None) -> Mesh:
    """A [n_outer, n_inner] mesh of the first n_outer * n_inner cards (or
    of `devices`), the outer axis across groups of independent streams and
    the inner one within a group. With a group, as JAX's hybrid layout
    over slices: the outer axis runs across ranks, n_outer / world_size
    rows a rank (ValueError unless that divides), and each row's n_inner
    devices are one rank's (its `devices`, the group's by default)."""
    if group is None:
        devs = _device_list(n_outer * n_inner, devices)
        return _mesh(devs, (n_outer, n_inner), axes)
    if n_outer % group.world_size:
        raise ValueError(f"the outer axis of {n_outer} does not divide "
                         f"over {group.world_size} processes")
    devs, ranks = _over_ranks(n_outer * n_inner, devices, group)
    return _mesh(devs, (n_outer, n_inner), axes, ranks, group)


def shard_batch(mesh: Mesh, x, axis: str = "ch",
                dim: int = 0) -> list[torch.Tensor]:
    """Split x along `dim` into mesh.shape[axis] equal shards, shard i on
    the i-th device along `axis` (at index 0 of a 2-D mesh's other
    axis); None for a shard another rank drives."""
    devs = mesh.axis_devices(axis)
    x = torch.as_tensor(x)
    if x.shape[dim] % len(devs):
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split over {len(devs)} shards")
    return [p.to(d) if r == mesh.rank else None
            for p, d, r in zip(torch.chunk(x, len(devs), dim), devs,
                               mesh.axis_ranks(axis))]


class _Shard:
    """One shard: its device, the rank that drives it, and where that is
    this process, its chain (a replica of the caller's) and, on a card,
    its own stream."""

    def __init__(self, chain: RxChain | None, device: torch.device,
                 label: str, rank: int = 0, local: bool = True):
        self.device = device
        self.label = label
        self.rank = rank
        self.local = local
        self.rx = (None if chain is None or not local
                   else chain.replica(device))
        self.stream = (torch.cuda.Stream(device)
                       if local and device.type == "cuda" else None)

    @contextlib.contextmanager
    def on(self):
        """The shard's device and stream as current (nothing on the CPU)."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield


def _handover(tensors, src_stream, dst_stream) -> None:
    """Tensors made on src_stream become safe to use on dst_stream (None:
    the CPU): it waits for them, and the allocator keeps their memory until
    its work is done."""
    if dst_stream is None:
        return
    if src_stream is not None and src_stream != dst_stream:
        dst_stream.wait_event(src_stream.record_event())
    for t in tensors:
        t.record_stream(dst_stream)


def _current(device: torch.device):
    return (torch.cuda.current_stream(device) if device.type == "cuda"
            else None)


def _fields(res: RxResult) -> dict[str, torch.Tensor]:
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(RxResult)}


class _Programs:
    """What the sharded programs share: their shards (those of other ranks
    as placeholders), the copy streams (one per card of this rank), the
    process group and the log of transfers and schedule events."""

    def __init__(self, chain: RxChain | None, mesh: Mesh, devices, ranks,
                 labels):
        """A shard for each of the devices of mesh (with its rank and
        label), in the program's order. ValueError, on every rank alike,
        where a rank of the mesh drives none of them (a program over one
        axis of a 2-D mesh whose other axis runs across the ranks)."""
        idle = sorted(set(mesh.ranks.flat) - set(ranks))
        if idle:
            raise ValueError(
                f"the program's shards {list(labels)} hold none of process "
                f"{idle[0]}'s devices: over processes, lay the program's "
                "axis across them or give it every axis of the mesh")
        self.group = mesh.group
        self.shards = [_Shard(chain, d, lab, r, r == mesh.rank)
                       for d, lab, r in zip(devices, labels, ranks)]
        self.copy_streams = {}
        for sh in self.shards:
            if sh.stream is not None and sh.device not in self.copy_streams:
                self.copy_streams[sh.device] = torch.cuda.Stream(sh.device)
        self.out_dev = next(sh.device for sh in self.shards if sh.local)
        self.log: list[dict] = []
        self._tag = 0
        self._sent = []

    def begin(self) -> None:
        """A new call: its log and the tags of its transfers start anew."""
        self.log.clear()
        self._tag = 0

    def note(self, kind: str, **entry) -> None:
        self.log.append({"seq": len(self.log), "kind": kind, **entry})

    def send(self, t: torch.Tensor, src: _Shard, dst: _Shard, kind: str,
             block: int, src_stream):
        """Copy t (made on src_stream, on src's device) into a fresh tensor
        on dst's device, on the copy stream, behind an event; log it. Where
        src is another rank's, t is a tensor of its shape and dtype on the
        "meta" device. Every rank calls this for every transfer of the
        program, in the same order; a rank that drives neither shard does
        nothing. -> what receive_on takes on dst (None where dst is
        another rank's)."""
        self._tag += 1
        if not (src.local or dst.local):
            return None
        entry = {"bytes": t.numel() * t.element_size(), "src": src.label,
                 "dst": dst.label, "block": block}
        if src.rank != dst.rank:
            staged = self.group.staged(src.device, dst.device)
            self.note(kind, **entry, src_rank=src.rank, dst_rank=dst.rank,
                      staged=staged)
            with torch.profiler.record_function(f"mercury::{kind}"):
                if src.local:
                    self._sent.append(dist.post_send(
                        self.group, t, dst.rank, self._tag, src_stream))
                    return None
                return dist.Received(self.group, t.shape, t.dtype, src.rank,
                                     self._tag, dst.device,
                                     self.copy_streams.get(dst.device))
        self.note(kind, **entry)
        if dst.stream is None:
            return t.to(dst.device, copy=True), None
        cs_src = self.copy_streams[src.device]
        cs_dst = self.copy_streams[dst.device]
        # the copy runs on the source card's current stream and waits for
        # the destination's: both are copy streams
        with torch.profiler.record_function(f"mercury::{kind}"), \
                torch.cuda.stream(cs_src), torch.cuda.stream(cs_dst):
            _handover([t], src_stream, cs_src)
            out = torch.empty(t.shape, dtype=t.dtype, device=dst.device)
            out.copy_(t, non_blocking=True)
            done = cs_dst.record_event()
        return out, done

    def receive_on(self, dst: _Shard, sent) -> torch.Tensor:
        """What send gave dst becomes usable on dst's stream (a receive from
        another rank is waited for first). -> the tensor."""
        t, done = sent.wait() if isinstance(sent, dist.Received) else sent
        if done is not None:
            dst.stream.wait_event(done)
            t.record_stream(dst.stream)
        return t

    def finish(self) -> None:
        """Wait for this call's sends to other ranks."""
        for work, _keep in self._sent:
            work.wait()
        self._sent.clear()

    def gather(self, parts: dict, blocks: int = 1) -> dict:
        """{(block, shard index): (shard, {name: tensor})} of the shards this
        rank drives (made on their streams) -> the same for every shard of
        the program and block < blocks, on out_dev: across ranks through
        one all_gather over the group, its bytes logged as one "gather"
        entry."""
        out = {}
        for key, (sh, fields) in parts.items():
            cur = _current(sh.device)
            for t in fields.values():
                _handover([t], sh.stream, cur)
            out[key] = {name: t.to(self.out_dev)
                        for name, t in fields.items()}
        if self.group is None:
            return out
        mine = sorted(out)
        flat = torch.cat([out[k][name].reshape(-1).view(torch.uint8)
                          for k in mine for name in out[k]])
        self.note("gather", bytes=flat.numel(), ranks=self.group.world_size,
                  staged=self.group.staged(self.out_dev))
        every = dist.all_gather_bytes(self.group, flat)
        # every rank drives as many shards, each part's the shapes of ours
        like = out[mine[0]]
        for r, buf in enumerate(every):
            if r == self.group.rank:
                continue
            keys = sorted((kk, s) for kk in range(blocks)
                          for s, sh in enumerate(self.shards) if sh.rank == r)
            at = 0
            for key in keys:
                got = {}
                for name, t in like.items():
                    n = t.numel() * t.element_size()
                    got[name] = buf[at: at + n].clone().view(
                        t.dtype).reshape(t.shape)
                    at += n
                out[key] = got
        return out


def channel_parallel_receive(rx_chain: RxChain, mesh: Mesh,
                             axis: str = "ch"):
    """RxChain.receive over the channel axis: each shard's rows go through
    an unmodified receive of its own chain on its device and, on a card,
    its own stream, the shards in turn, with no bytes moved
    between shards (the program's log holds no transfer; over ranks, its
    gather). -> f(pb) where pb is [B, n] (split with shard_batch) or a
    list of per-shard buffers -> RxResult [B, ...] on the first shard's
    device (of this rank's shards)."""
    devs = mesh.axis_devices(axis)
    prog = _Programs(rx_chain, mesh, devs, mesh.axis_ranks(axis),
                     [f"{axis}{i}" for i in range(len(devs))])

    def run(pb) -> RxResult:
        prog.begin()
        parts = (list(pb) if isinstance(pb, (list, tuple))
                 else shard_batch(mesh, pb, axis))
        mine = [(s, sh, x) for s, (sh, x) in enumerate(zip(prog.shards,
                                                           parts))
                if sh.local]
        for _s, sh, x in mine:
            _handover([x], _current(x.device), sh.stream)

        results = {}
        for s, sh, x in mine:
            with sh.on():
                results[0, s] = (sh, _fields(sh.rx.receive(x)))
        out = prog.gather(results)
        return RxResult(**{f.name: torch.cat([out[0, s][f.name]
                                              for s in range(len(devs))])
                           for f in dataclasses.fields(RxResult)})

    run.log = prog.log
    run.shards = prog.shards
    return run


def spmd_overhead_curve(rx_chain: RxChain, device_counts=(1, 2, 4, 8),
                        total_batch: int = 16, reps: int = 3,
                        device=None) -> list[dict]:
    """Fixed-total-work overhead of the channel-parallel receive: the same
    total_batch buffers of white noise (numpy, seed 0) decoded on 1, 2, 4,
    8 shards; wall_ms is the mean of reps calls after one warm-up, each
    ending in a synchronize, and overhead_vs_1dev its ratio to the first
    count's. device None: the first d cards (a count above the cards, or
    not dividing total_batch, is skipped); a device: a virtual mesh of d
    shards on it, where the ratio measures what the sharding itself costs
    or saves on one card."""
    g = rx_chain.geom
    buf_len = g.nofdm * g.buffer_nsymb * g.interp
    rng = np.random.default_rng(0)
    buf = torch.as_tensor(
        rng.standard_normal((total_batch, buf_len)).astype(np.float32))
    out, base = [], None
    for d in device_counts:
        if total_batch % d:
            continue
        if device is None:
            if d > torch.cuda.device_count():
                continue
            mesh = make_mesh(d)
        else:
            mesh = make_mesh(d, devices=[device] * d)
        run = channel_parallel_receive(rx_chain, mesh)
        x = buf.to(mesh.devices.flat[0])

        def sync():
            if x.is_cuda:
                torch.cuda.synchronize(x.device)

        run(x)
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            run(x)
        sync()
        dt = (time.perf_counter() - t0) / reps
        base = dt if base is None else base
        out.append({"devices": d, "total_batch": total_batch,
                    "wall_ms": dt * 1e3, "overhead_vs_1dev": dt / base})
    return out


def halo_exchange(parts: list, left: int, right: int,
                  prog: _Programs) -> list:
    """Overlap-save halos of the shards' slices [..., n_local] in time
    order: each gets `left` samples of its left neighbour's tail before it
    and `right` of its right neighbour's head after it, zeros at the stream
    edges -> [..., left + n_local + right] per shard, on each shard's
    stream. prog holds the shards (one per part, in time order; JAX's axis
    name) and the log. A part is None where another rank drives its shard
    (and so is its result); halos to and from it cross processes."""
    n = len(parts)
    like = next(p for p in parts if p is not None)
    src = [None if p is None else _current(p.device) for p in parts]
    for sh, x, s in zip(prog.shards, parts, src):
        if x is not None:
            _handover([x], s, sh.stream)

    def piece(j: int, nb: int, cut: slice, width: int):
        """Shard j's halo from shard nb's samples at cut (zeros past an
        edge); None where j is another rank's."""
        sh = prog.shards[j]
        if 0 <= nb < n:
            t = (parts[nb][..., cut].contiguous() if parts[nb] is not None
                 else torch.empty(like.shape[:-1] + (width,),
                                  dtype=like.dtype, device="meta"))
            sent = prog.send(t, prog.shards[nb], sh, "halo", 0, src[nb])
            return prog.receive_on(sh, sent) if sh.local else None
        if not sh.local:
            return None
        with sh.on():
            return parts[j].new_zeros(parts[j].shape[:-1] + (width,))

    out = []
    for j, sh in enumerate(prog.shards):
        pieces = [parts[j]]
        if left:
            pieces.insert(0, piece(j, j - 1, slice(-left, None), left))
        if right:
            pieces.append(piece(j, j + 1, slice(0, right), right))
        if not sh.local:
            out.append(None)
            continue
        with sh.on():
            out.append(torch.cat(pieces, dim=-1))
    return out


def time_sharded_fir(mesh: Mesh, taps, time_axis: str = "t"):
    """Streaming FIR over a time-sharded signal with overlap-save halos from
    both neighbours: -> f(x [B, N]) -> ops.fir_same(x, taps) [B, N] on the
    first shard's device, each shard filtering its slice extended by the
    halos (the taps' centre on the left, the rest on the right). f.log
    lists the halo transfers of the last call."""
    taps = torch.as_tensor(np.asarray(taps, np.float32))
    ntaps = taps.shape[0]
    left = (ntaps - 1) // 2
    right = ntaps - 1 - left
    n_dev = mesh.shape[time_axis]
    prog = _Programs(None, mesh, mesh.axis_devices(time_axis),
                     mesh.axis_ranks(time_axis),
                     [f"{time_axis}{i}" for i in range(n_dev)])
    taps_on = {sh.device: taps.to(sh.device) for sh in prog.shards
               if sh.local}

    def run(x) -> torch.Tensor:
        prog.begin()
        x = torch.as_tensor(x)
        parts = shard_batch(mesh, x, time_axis, dim=-1)
        n_local = x.shape[-1] // n_dev
        ext = halo_exchange(parts, left, right, prog)
        outs = {}
        for s, (sh, e) in enumerate(zip(prog.shards, ext)):
            if e is None:
                continue
            with sh.on():
                y = ops.fir_same(e, taps_on[sh.device])
                y = y[..., left: left + n_local]
            outs[0, s] = (sh, {"y": y})
        prog.finish()
        got = prog.gather(outs)
        return torch.cat([got[0, s]["y"] for s in range(n_dev)], dim=-1)

    run.log = prog.log
    return run


def _halo_len(rx_chain: RxChain, halo: int | None) -> tuple[int, int]:
    """(halo, one symbol) in interp samples: the halo one frame + 2
    symbols unless given."""
    g = rx_chain.geom
    sym = g.nofdm * g.interp
    if halo is None:
        halo = (g.nofdm * (rx_chain.active_nsymb + g.preamble_nsymb)
                * g.interp + 2 * sym)
    return halo, sym


class _TimeSharded:
    """The block-pipelined time-sharded receive over groups of shards (one
    group per index of batch_axis; a group time-shards its rows of the
    stream batch over time_axis). See time_sharded_receive_stream.

    Over ranks, every rank walks the same schedule, each transfer of the
    program in its place, and drives only its own shards in it:
      fetch(0): block 0's halos (each group, each shard, in order);
      step k: wait for block k's halos bound here, in order; fetch(k + 1),
        posted before block k decodes; decode block k; post block k's
        dedupe rows (shard j - 1 -> j, and the last shard of block k - 1
        -> shard 0; each group, each shard, in order), then wait for those
        bound here;
      then wait for the call's sends, and the gather.
    Posts do not block, and a rank waits only for a transfer that its peer
    posts before it waits on anything posted later, so no order of the
    ranks deadlocks."""

    def __init__(self, rx_chain: RxChain, mesh: Mesh, time_axis: str,
                 halo: int | None, batch_axis: str | None):
        self.mesh = mesh
        self.time_axis = time_axis
        self.batch_axis = batch_axis
        self.halo, self.sym = _halo_len(rx_chain, halo)
        n_groups = mesh.shape[batch_axis] if batch_axis else 1
        self.groups = [mesh.axis_devices(time_axis, gi)
                       for gi in range(n_groups)]
        devs = [d for grp in self.groups for d in grp]
        ranks = [r for gi in range(n_groups)
                 for r in mesh.axis_ranks(time_axis, gi)]
        labels = [f"{batch_axis}{gi}.{time_axis}{j}" if batch_axis
                  else f"{time_axis}{j}"
                  for gi, grp in enumerate(self.groups)
                  for j in range(len(grp))]
        self.prog = _Programs(rx_chain, mesh, devs, ranks, labels)
        self.log = self.prog.log

    def __call__(self, pb) -> RxResult:
        """pb [B, K, n_total] -> RxResult [K, n_dev, B]."""
        prog = self.prog
        prog.begin()
        pb = torch.as_tensor(pb)
        b, k_blocks, n_total = pb.shape
        n_dev, n_groups = len(self.groups[0]), len(self.groups)
        if n_total % n_dev or b % n_groups:
            raise ValueError(f"[{b}, {k_blocks}, {n_total}] does not split "
                             f"over {n_groups} x {n_dev} shards")
        n_local = n_total // n_dev
        bg = b // n_groups
        if self.halo > n_local:
            raise ValueError(f"halo {self.halo} exceeds the slice {n_local}")
        shards = [prog.shards[gi * n_dev: (gi + 1) * n_dev]
                  for gi in range(n_groups)]
        # each of this rank's shards' slices [Bg, K, n_local] and, for
        # sending, their heads [K, Bg, halo], made on the shard's stream
        blocks, heads = {}, {}
        for gi in range(n_groups):
            for j, sh in enumerate(shards[gi]):
                if not sh.local:
                    continue
                x = pb[gi * bg: (gi + 1) * bg, :,
                       j * n_local: (j + 1) * n_local].to(sh.device)
                _handover([x], _current(sh.device), sh.stream)
                with sh.on():
                    blocks[gi, j] = x.contiguous()
                    heads[gi, j] = blocks[gi, j][:, :, :self.halo].transpose(
                        0, 1).contiguous()
        head_like = torch.empty((bg, self.halo), dtype=pb.dtype,
                                device="meta")

        def fetch(kk):
            """Issue the halos of block kk: shard j's from shard j+1's head
            of block kk, the last shard's from shard 0's head of block
            kk+1 (zeros past the last block). -> {(group, shard): (what
            receive_on takes, whether it was sent)} for this rank's
            shards."""
            got = {}
            for gi in range(n_groups):
                for j, sh in enumerate(shards[gi]):
                    src_j, src_k = ((j + 1, kk) if j + 1 < n_dev
                                    else (0, kk + 1))
                    if src_k < k_blocks:
                        src = shards[gi][src_j]
                        t = heads[gi, src_j][src_k] if src.local else head_like
                        sent = prog.send(t, src, sh, "halo", kk, src.stream)
                        if sh.local:
                            got[gi, j] = (sent, True)
                    elif sh.local:
                        with sh.on():
                            got[gi, j] = ((torch.zeros(
                                (bg, self.halo), dtype=pb.dtype,
                                device=sh.device), None), False)
            return got

        def decode(gi, j, kk, halo_t):
            sh = shards[gi][j]
            with sh.on():
                ext = torch.cat([blocks[gi, j][:, kk], halo_t], dim=-1)
                res = sh.rx.receive(ext, sync_limit=n_local)
                gd = (kk * n_total + j * n_local + res.delay).to(torch.int32)
                claim = res.crc_ok & (res.delay < n_local)
            return res, claim, gd

        halos = fetch(0)
        outs = {}
        left = {}          # (group) -> the last shard's raw claim of block k-1
        for kk in range(k_blocks):
            ready = {}
            for (gi, j), (sent, was_sent) in halos.items():
                if was_sent:
                    prog.note("wait", dst=shards[gi][j].label, block=kk)
                ready[gi, j] = prog.receive_on(shards[gi][j], sent)
            # double buffer: block kk+1's halos go out before block kk
            # decodes, and block kk does not read them
            nxt = fetch(kk + 1) if kk + 1 < k_blocks else None
            prog.note("decode", block=kk)
            dec = {key: decode(*key, kk, ready[key]) for key in ready}
            prog.note("decoded", block=kk)
            outs.update(self._dedupe(shards, dec, left, kk, bg))
            halos = nxt
        prog.finish()
        got = prog.gather(outs, k_blocks)
        # fields [K, n_dev, B]: each block's shards along time, each the
        # groups' rows in turn
        return RxResult(**{
            f.name: torch.stack([torch.stack([
                torch.cat([got[kk, gi * n_dev + j][f.name]
                           for gi in range(n_groups)])
                for j in range(n_dev)]) for kk in range(k_blocks)])
            for f in dataclasses.fields(RxResult)})

    def _dedupe(self, shards, dec, left, kk, bg) -> dict:
        """Seam dedupe of block kk: shard j drops a claim within one symbol
        of its left neighbour's (shard j-1's raw claim; for shard 0 the last
        shard's of block kk-1). Every dedupe row is posted, then those bound
        for this rank's shards are read. -> {(kk, shard index): (shard,
        fields)} of this rank's shards, with the claims and global
        delays."""
        prog = self.prog
        n_dev = len(shards[0])
        pair_like = torch.empty((2, bg), dtype=torch.int32, device="meta")
        sent = {}
        for gi in range(len(shards)):
            for j, sh in enumerate(shards[gi]):
                if j > 0:
                    src_sh = shards[gi][j - 1]
                    pair = pair_like
                    if src_sh.local:
                        with src_sh.on():
                            pair = self._claims(dec[gi, j - 1])
                elif kk > 0:
                    src_sh = shards[gi][-1]
                    pair = left[gi] if src_sh.local else pair_like
                else:
                    continue
                got = prog.send(pair, src_sh, sh, "dedupe", kk, src_sh.stream)
                if sh.local:
                    sent[gi, j] = got
            if shards[gi][-1].local:
                with shards[gi][-1].on():
                    left[gi] = self._claims(dec[gi, n_dev - 1])
        out = {}
        for gi in range(len(shards)):
            for j, sh in enumerate(shards[gi]):
                if not sh.local:
                    continue
                res, claim, gd = dec[gi, j]
                if (gi, j) in sent:
                    t = prog.receive_on(sh, sent[gi, j])
                    with sh.on():
                        dup = (t[0] > 0) & (torch.abs(t[1] - gd) < self.sym)
                        claim = claim & ~dup
                out[kk, gi * n_dev + j] = (sh, _fields(RxResult(
                    res.payload, claim, gd, res.freq_offset, res.snr_db,
                    res.iters, res.sync_metric, res.mean_h)))
        return out

    @staticmethod
    def _claims(decoded) -> torch.Tensor:
        """A shard's raw claims and global delays as one int32 [2, B]
        tensor: one dedupe transfer of 8 bytes a row."""
        _res, claim, gd = decoded
        return torch.stack([claim.to(torch.int32), gd])


def time_sharded_receive(rx_chain: RxChain, mesh: Mesh,
                         time_axis: str = "t", halo: int | None = None,
                         batch_axis: str | None = None):
    """Full receive over one long capture stream time-sharded across the
    mesh: each shard extends its slice with a right halo (one frame + 2
    symbols) from its right neighbour (zeros at the stream's end), receives
    with sync_limit = its slice length, and claims a frame only where it
    passes its CRC and starts inside the slice; delays are globalized, and
    at a seam the left shard wins a frame both decoded (within one symbol).
    A slice holds at most one frame start. batch_axis: on a 2-D mesh the
    stream batch is split over this axis, each group time-sharded over its
    own shards. -> f(pb [B, N]) -> RxResult [n_dev, B] on the first shard's
    device (of this rank's: over ranks, every rank passes the whole pb and
    gets the whole result); f.log is the last call's log."""
    prog = _TimeSharded(rx_chain, mesh, time_axis, halo, batch_axis)

    def run(pb) -> RxResult:
        res = prog(torch.as_tensor(pb)[:, None])
        return RxResult(**{f.name: getattr(res, f.name)[0]
                           for f in dataclasses.fields(RxResult)})

    run.log = prog.log
    run.shards = prog.prog.shards
    return run


def time_sharded_receive_stream(rx_chain: RxChain, mesh: Mesh,
                                n_blocks: int, time_axis: str = "t",
                                halo: int | None = None,
                                batch_axis: str | None = None):
    """time_sharded_receive over K consecutive blocks of one continuous
    capture, pb [B, K, n_total], with the halo exchange double-buffered:
    the halos of block k+1 are issued before block k decodes and waited on
    only at step k+1, so the copies can run under block k's kernels. Stream
    continuity is exact: the last shard's halo of block k is shard 0's head
    of block k+1, and shard 0 of block k+1 drops a frame the last shard of
    block k claimed. -> f(pb) -> RxResult [K, n_dev, B] on the first
    shard's device, delays global to the stream; f.log is the last call's
    log (scale.analysis.audit_overlap_structure reads it)."""
    prog = _TimeSharded(rx_chain, mesh, time_axis, halo, batch_axis)

    def run(pb) -> RxResult:
        pb = torch.as_tensor(pb)
        if pb.shape[1] != n_blocks:
            raise ValueError(f"expected {n_blocks} blocks, got {pb.shape[1]}")
        return prog(pb)

    run.log = prog.log
    run.shards = prog.prog.shards
    return run
