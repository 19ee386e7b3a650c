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
in turn; a receive reads results on the host several times (the LDPC once
a sweep), so on one card the shards' receives follow one another, while
the halo copies run under them on a copy stream. A tensor that crosses
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
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from mercury_tpu_torch.dsp import ops
from mercury_tpu_torch.modem.rx import RxChain, RxResult


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """devices: a numpy object array of torch.device, one axis per name."""
    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str, index: int = 0) -> list[torch.device]:
        """The devices along `axis`, at `index` of the other axis (if any)."""
        a = self.axis_names.index(axis)
        arr = np.moveaxis(self.devices, a, -1).reshape(
            -1, self.devices.shape[a])
        return list(arr[index])


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


def _mesh(devs: list[torch.device], shape, axes) -> Mesh:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axes))


def make_mesh(n_devices: int | None = None, axis: str = "ch",
              devices=None) -> Mesh:
    """A 1-D mesh of the first n_devices CUDA cards (all of them by
    default; ValueError if there are fewer), or of the first n_devices of
    `devices`, which may repeat a device (a virtual mesh)."""
    devs = _device_list(n_devices, devices)
    return _mesh(devs, (len(devs),), (axis,))


def make_mesh_2d(n_outer: int, n_inner: int,
                 axes: tuple[str, str] = ("dcn", "ch"), devices=None) -> Mesh:
    """A [n_outer, n_inner] mesh of the first n_outer * n_inner cards (or
    of `devices`), the outer axis across groups of independent streams and
    the inner one within a group. One process has no hosts to lay the outer
    axis across; JAX's multi-slice layout has no counterpart here."""
    devs = _device_list(n_outer * n_inner, devices)
    return _mesh(devs, (n_outer, n_inner), axes)


def shard_batch(mesh: Mesh, x, axis: str = "ch",
                dim: int = 0) -> list[torch.Tensor]:
    """Split x along `dim` into mesh.shape[axis] equal shards, shard i on
    the i-th device along `axis` (at index 0 of a 2-D mesh's other
    axis)."""
    devs = mesh.axis_devices(axis)
    x = torch.as_tensor(x)
    if x.shape[dim] % len(devs):
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split over {len(devs)} shards")
    return [p.to(d) for p, d in zip(torch.chunk(x, len(devs), dim), devs)]


class _Shard:
    """One shard: its device, its chain (a replica of the caller's) and, on
    a card, its own stream."""

    def __init__(self, chain: RxChain | None, device: torch.device,
                 label: str):
        self.device = device
        self.label = label
        self.rx = None if chain is None else chain.replica(device)
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

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


class _Programs:
    """What the sharded programs share: their shards, the copy streams
    (one per card) and the log of transfers and schedule events."""

    def __init__(self, chain: RxChain | None, devices, labels):
        self.shards = [_Shard(chain, d, lab) for d, lab in zip(devices,
                                                              labels)]
        self.copy_streams = {}
        for sh in self.shards:
            if sh.stream is not None and sh.device not in self.copy_streams:
                self.copy_streams[sh.device] = torch.cuda.Stream(sh.device)
        self.log: list[dict] = []

    def note(self, kind: str, **entry) -> None:
        self.log.append({"seq": len(self.log), "kind": kind, **entry})

    def send(self, t: torch.Tensor, src: _Shard, dst: _Shard, kind: str,
             block: int, src_stream):
        """Copy t (made on src_stream, on src's device) into a fresh tensor
        on dst's device, on the copy stream, behind an event; log it.
        -> (the copy, the event that marks it done, None on the CPU)."""
        self.note(kind, bytes=t.numel() * t.element_size(), src=src.label,
                  dst=dst.label, block=block)
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

    def receive_on(self, dst: _Shard, t: torch.Tensor, done) -> None:
        """A sent tensor becomes usable on dst's stream."""
        if done is not None:
            dst.stream.wait_event(done)
            t.record_stream(dst.stream)

    def gather(self, results: list[RxResult], stack: bool) -> RxResult:
        """Per-shard results (on their shards' streams) -> one RxResult on
        the first shard's device: fields stacked on a new leading axis, or
        concatenated along the batch."""
        out_dev = self.shards[0].device
        fields = {}
        for f in dataclasses.fields(RxResult):
            parts = []
            for sh, res in results:
                t = getattr(res, f.name)
                cur = _current(sh.device)
                _handover([t], sh.stream, cur)
                parts.append(t.to(out_dev))
            fields[f.name] = (torch.stack(parts) if stack
                              else torch.cat(parts))
        return RxResult(**fields)


def channel_parallel_receive(rx_chain: RxChain, mesh: Mesh,
                             axis: str = "ch"):
    """RxChain.receive over the channel axis: each shard's rows go through
    an unmodified receive of its own chain on its device and, on a card,
    its own stream, the shards in turn, with no bytes moved
    between shards (the program's log stays empty). -> f(pb) where pb is
    [B, n] (split with shard_batch) or a list of per-shard buffers ->
    RxResult [B, ...] on the first shard's device."""
    devs = mesh.axis_devices(axis)
    prog = _Programs(rx_chain, devs, [f"{axis}{i}" for i in range(len(devs))])

    def run(pb) -> RxResult:
        parts = (list(pb) if isinstance(pb, (list, tuple))
                 else shard_batch(mesh, pb, axis))
        for sh, x in zip(prog.shards, parts):
            _handover([x], _current(x.device), sh.stream)

        results = []
        for sh, x in zip(prog.shards, parts):
            with sh.on():
                results.append((sh, sh.rx.receive(x)))
        return prog.gather(results, stack=False)

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


def halo_exchange(parts: list[torch.Tensor], left: int, right: int,
                  prog: _Programs) -> list[torch.Tensor]:
    """Overlap-save halos of the shards' slices [..., n_local] in time
    order: each gets `left` samples of its left neighbour's tail before it
    and `right` of its right neighbour's head after it, zeros at the stream
    edges -> [..., left + n_local + right] per shard, on each shard's
    stream. prog holds the shards (one per part, in time order; JAX's axis
    name) and the log."""
    n = len(parts)
    src = [_current(p.device) for p in parts]
    for sh, x, s in zip(prog.shards, parts, src):
        _handover([x], s, sh.stream)

    def piece(j: int, nb: int, cut: slice, width: int) -> torch.Tensor:
        """Shard j's halo from shard nb's samples at cut (zeros past an
        edge)."""
        sh = prog.shards[j]
        if 0 <= nb < n:
            t, done = prog.send(parts[nb][..., cut].contiguous(),
                                prog.shards[nb], sh, "halo", 0, src[nb])
            prog.receive_on(sh, t, done)
            return t
        with sh.on():
            return parts[j].new_zeros(parts[j].shape[:-1] + (width,))

    out = []
    for j, sh in enumerate(prog.shards):
        pieces = [parts[j]]
        if left:
            pieces.insert(0, piece(j, j - 1, slice(-left, None), left))
        if right:
            pieces.append(piece(j, j + 1, slice(0, right), right))
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
    devs = mesh.axis_devices(time_axis)
    prog = _Programs(None, devs, [f"{time_axis}{i}" for i in range(len(devs))])
    taps_on = {d: taps.to(d) for d in set(devs)}

    def run(x) -> torch.Tensor:
        prog.log.clear()
        parts = shard_batch(mesh, x, time_axis, dim=-1)
        n_local = parts[0].shape[-1]
        ext = halo_exchange(parts, left, right, prog)
        outs = []
        for sh, e in zip(prog.shards, ext):
            with sh.on():
                y = ops.fir_same(e, taps_on[sh.device])
                y = y[..., left: left + n_local]
            _handover([y], sh.stream, _current(sh.device))
            outs.append(y.to(prog.shards[0].device))
        return torch.cat(outs, dim=-1)

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
    stream batch over time_axis). See time_sharded_receive_stream."""

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
        labels = [f"{batch_axis}{gi}.{time_axis}{j}" if batch_axis
                  else f"{time_axis}{j}"
                  for gi, grp in enumerate(self.groups)
                  for j in range(len(grp))]
        self.prog = _Programs(rx_chain, devs, labels)
        self.log = self.prog.log

    def __call__(self, pb) -> RxResult:
        """pb [B, K, n_total] -> RxResult [K, n_dev, B]."""
        prog = self.prog
        prog.log.clear()
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
        # each shard's slices [Bg, K, n_local] and, for sending, their
        # heads [K, Bg, halo], made on the shard's stream
        blocks, heads = {}, {}
        for gi in range(n_groups):
            for j, sh in enumerate(shards[gi]):
                x = pb[gi * bg: (gi + 1) * bg, :,
                       j * n_local: (j + 1) * n_local].to(sh.device)
                _handover([x], _current(sh.device), sh.stream)
                with sh.on():
                    blocks[gi, j] = x.contiguous()
                    heads[gi, j] = blocks[gi, j][:, :, :self.halo].transpose(
                        0, 1).contiguous()

        def fetch(kk):
            """Issue the halos of block kk: shard j's from shard j+1's head
            of block kk, the last shard's from shard 0's head of block
            kk+1 (zeros past the last block). -> {(group, shard): (halo,
            its copy's event or None, whether it was sent)}."""
            got = {}
            for gi in range(n_groups):
                for j, sh in enumerate(shards[gi]):
                    src_j, src_k = ((j + 1, kk) if j + 1 < n_dev
                                    else (0, kk + 1))
                    if src_k < k_blocks:
                        src = shards[gi][src_j]
                        got[gi, j] = (*prog.send(heads[gi, src_j][src_k],
                                                 src, sh, "halo", kk,
                                                 src.stream), True)
                    else:
                        with sh.on():
                            got[gi, j] = (torch.zeros(
                                (bg, self.halo), dtype=pb.dtype,
                                device=sh.device), None, False)
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
        outs = []
        left = {}          # (group) -> the last shard's raw claim of block k-1
        for kk in range(k_blocks):
            for (gi, j), (t, done, sent) in halos.items():
                if sent:
                    prog.note("wait", dst=shards[gi][j].label, block=kk)
                prog.receive_on(shards[gi][j], t, done)
            # double buffer: block kk+1's halos go out before block kk
            # decodes, and block kk does not read them
            nxt = fetch(kk + 1) if kk + 1 < k_blocks else None
            prog.note("decode", block=kk)
            dec = {key: decode(*key, kk, halos[key][0]) for key in halos}
            prog.note("decoded", block=kk)
            outs.append(self._dedupe(shards, dec, left, kk, bg))
            halos = nxt
        # [K][group][shard] -> fields [K, n_dev, B]
        per_block = []
        for kk in range(k_blocks):
            rows = [prog.gather([outs[kk][gi][j] for gi in range(n_groups)],
                                stack=False) for j in range(n_dev)]
            per_block.append(rows)
        return RxResult(**{
            f.name: torch.stack([torch.stack([getattr(r, f.name)
                                              for r in rows])
                                 for rows in per_block])
            for f in dataclasses.fields(RxResult)})

    def _dedupe(self, shards, dec, left, kk, bg):
        """Seam dedupe of block kk: shard j drops a claim within one symbol
        of its left neighbour's (shard j-1's raw claim; for shard 0 the last
        shard's of block kk-1). -> [group][shard] of (shard, RxResult) with
        the claims and global delays."""
        prog = self.prog
        n_dev = len(shards[0])
        out = []
        for gi in range(len(shards)):
            row = []
            for j, sh in enumerate(shards[gi]):
                res, claim, gd = dec[gi, j]
                if j > 0:
                    src_sh = shards[gi][j - 1]
                    with src_sh.on():
                        pair = self._claims(dec[gi, j - 1])
                elif gi in left:
                    src_sh, pair = shards[gi][-1], left[gi]
                else:
                    src_sh = None
                if src_sh is not None:
                    t, done = prog.send(pair, src_sh, sh, "dedupe", kk,
                                        src_sh.stream)
                    prog.receive_on(sh, t, done)
                    with sh.on():
                        dup = (t[0] > 0) & (torch.abs(t[1] - gd) < self.sym)
                        claim = claim & ~dup
                row.append((sh, RxResult(res.payload, claim, gd,
                                         res.freq_offset, res.snr_db,
                                         res.iters, res.sync_metric,
                                         res.mean_h)))
            with shards[gi][-1].on():
                left[gi] = self._claims(dec[gi, n_dev - 1])
            out.append(row)
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
    device; f.log is the last call's log."""
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
