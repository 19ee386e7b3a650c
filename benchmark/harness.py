"""One run of one cell: set-up, the measured window, the traced stretch and
the check of what the window's rounds delivered.

Everything that belongs to a cell, a configuration or a metric is a file
found by its name in BENCHMARK.json: `workloads/<cell>.json`,
`configs/<config>.json`, `metrics/<metric>.py`.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import pathlib
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark import traffic, txref, yardstick

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mercury_tpu")
# rounds before the window: the first arms the pool, and by the third every
# shape of a cell has run (its first window rounds are no slower)
WARM_ROUNDS = 3


def load_spec(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, root: pathlib.Path = ROOT) -> dict:
    """The cell's BENCHMARK.json entry with its traffic file and its
    configuration file (under "mode")."""
    spec = load_spec(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    here = root / HERE.name
    cell = {**json.loads((here / "workloads" / f"{name}.json").read_text()),
            **entry}
    cell["mode"] = json.loads(
        (here / "configs" / f"{entry['config']}.json").read_text())
    return cell


def cell_metrics(trace: bool, root: pathlib.Path = ROOT) -> list:
    """The metrics a run reports: the end-to-end ones, or with trace the
    per-layer ones (every cell reports every metric)."""
    spec = load_spec(root)
    return spec["per_layer" if trace else "end_to_end"]


def reader(name: str, root: pathlib.Path = ROOT):
    """metrics/<name>.py's read(run) -> number or None."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Trace:
    """What the profiled stretch saw, on the trace's clock (microseconds)."""
    device_ops: list            # (name, start, end) of every device operation
    lo: float                   # the stretch: its first round's call
    hi: float                   # ... to its last round's results
    rounds: int
    launches: dict              # kernel -> bound_ms of each launch
    phases: list                # each round's (call, round() returned, end)

    @property
    def wall_s(self) -> float:
        return (self.hi - self.lo) * 1e-6


@dataclass
class Run:
    """A run as the metric readers see it."""
    channels: int
    chunk: int
    rounds: list                # (call, round() returned, unpack returned, frames)
    window_s: float
    setup_s: float
    setup_parts: dict = field(default_factory=dict)
    traced_rounds: int = 0      # the window's last rounds, profiled
    trace: Trace | None = None


def process_age_s() -> float | None:
    """Seconds since this process started (Linux), else None."""
    try:
        ticks = int(pathlib.Path("/proc/self/stat").read_text()
                    .rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return None


class _Launches:
    """Notes the work of each launch of the two hand kernels whose roofline
    the benchmark reports, while the profiled stretch runs: the benchmark's
    own wrappers around the program's kernel entry points."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.saved = {}
        self.notes = {"ldpc_layered": [], "mix_fir_decimate": []}

    def __enter__(self):
        k = self.kernels
        self.saved = {n: getattr(k, n) for n in self.notes}
        ldpc, fir = self.saved["ldpc_layered"], self.saved["mix_fir_decimate"]

        def ldpc_noted(llr, plan, max_iter, algo="spa", alpha=1.0, beta=0.0,
                       soft=False):
            out = ldpc(llr, plan, max_iter, algo, alpha, beta, soft)
            self.notes["ldpc_layered"].append(
                (plan.rate_num, llr.shape[0], algo, soft, max_iter, out[1]))
            return out

        def fir_noted(pb, osc, taps, stride, start=None, n_out=None,
                      offset=None, freq=None, fs=None):
            self.notes["mix_fir_decimate"].append(
                (pb.shape, start, n_out, stride, offset, taps.shape[0],
                 freq is not None))
            return fir(pb, osc, taps, stride, start, n_out, offset, freq, fs)

        k.ldpc_layered, k.mix_fir_decimate = ldpc_noted, fir_noted
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.kernels, name, fn)

    def bounds(self) -> dict:
        out = {"ldpc_layered": [], "mix_fir_decimate": []}
        for rate, rows, algo, soft, max_iter, iters in self.notes["ldpc_layered"]:
            if rows:
                sweeps = float(np.clip(iters.cpu().numpy(), 0, max_iter).mean())
                out["ldpc_layered"].append(yardstick.ldpc_bound_ms(
                    rate, rows, algo, sweeps, soft))
        for shape, start, n_out, stride, offset, ntaps, freq in \
                self.notes["mix_fir_decimate"]:
            rows, n = shape
            if start is None:
                start = np.zeros(rows, np.int64)
                n_out, offset = (n - 1) // stride + 1, (ntaps - 1) // 2
            else:
                start = start.cpu().numpy()
            out["mix_fir_decimate"].append(yardstick.fir_bound_ms(
                rows, n, start, n_out, stride, offset, ntaps, freq))
        return out


def _trace_of(prof, launches: _Launches, active: list) -> Trace:
    """The profiled rounds' device operations on the trace's clock, with
    the host clock's rounds mapped onto it by the first runtime call."""
    from torch.autograd import DeviceType
    events = prof.events()
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    first = min((e.time_range.start for e in events), default=0.0)
    shift = first - active[0][0] * 1e6
    phases = [(a * 1e6 + shift, b * 1e6 + shift, c * 1e6 + shift)
              for a, b, c, _ in active]
    return Trace(dev, phases[0][0], phases[-1][2], len(active),
                 launches.bounds(), phases)


def serve(cell: dict, seed: int, seconds: float, trace: bool,
          device: torch.device, t_start: float, parts: dict,
          rx_options: dict | None = None, fault=None) -> tuple[Run, dict]:
    """Set up the cell's pool and ring, warm it up over WARM_ROUNDS
    rounds, run rounds for `seconds` (with trace, then `traced_rounds`
    more under torch.profiler) and check the frames they delivered.
    -> (Run, checks)."""
    t = time.perf_counter()
    from mercury_tpu_torch.core.geometry import build_geometry
    from mercury_tpu_torch.dsp import kernels
    from mercury_tpu_torch.modem.rx import RxChain
    from mercury_tpu_torch.scale.serve import FusedDevicePool
    parts["import_program_s"] = time.perf_counter() - t
    if device.type == "cuda":
        t = time.perf_counter()
        from mercury_tpu_torch import native
        native.load_library()
        parts["kernels_s"] = time.perf_counter() - t

    mcfg = cell["mode"]
    t = time.perf_counter()
    mode = txref.build_mode(mcfg)
    ring = traffic.build_ring(mode, cell, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    parts["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    n_ch, n_ring = int(cell["channels"]), len(ring.views)
    geom = build_geometry(int(mcfg["config"]), estimator=mcfg["estimator"])
    opts = {**mcfg.get("rx_options", {}), **(rx_options or {})}
    pool = FusedDevicePool(geom, n_ch, rx=RxChain(geom, device=device, **opts))
    if fault is not None:
        fault(pool)
    blocks = ring.views
    parts["program_s"] = time.perf_counter() - t

    t = time.perf_counter()
    j = 0
    for j in range(WARM_ROUNDS):
        pool.unpack(pool.round(blocks[j % n_ring],
                               next_block=blocks[(j + 1) % n_ring]))
    if device.type == "cuda":
        torch.cuda.synchronize()
    # what set-up made lives as long as the run: keep the window's full
    # collections from scanning it, as a long-running server would
    gc.collect()
    gc.freeze()
    parts["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    traced = int(cell["traced_rounds"]) if trace else 0
    keep = int(cell["kept_every"])
    offset = int(np.random.default_rng(seed % 2 ** 63).integers(keep))
    kept, rounds = {}, []
    n_fb = ring.payloads.shape[2]
    prof = launches = None
    stretch = 0
    j += 1
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        packed = pool.round(blocks[j % n_ring],
                            next_block=blocks[(j + 1) % n_ring])
        b = time.perf_counter()
        out = pool.unpack(packed)
        c = time.perf_counter()
        rounds.append((a, b, c, len(out)))
        if (j + offset) % keep == 0:
            kept[j] = _compact(out, n_fb)
        j += 1
        if prof is not None:
            prof.step()
            stretch += 1
            if stretch == 1:
                launches.__enter__()
            elif stretch > traced:
                break
        elif c - t0 >= seconds:
            if not traced:
                break
            # then the window's last rounds under the profiler, device
            # activity only (recording every host operation would double a
            # host-bound round); its first round only warms CUPTI up
            from torch.profiler import ProfilerActivity, profile, schedule
            launches = _Launches(kernels)
            prof = profile(activities=[ProfilerActivity.CUDA
                                       if device.type == "cuda"
                                       else ProfilerActivity.CPU],
                           schedule=schedule(wait=0, warmup=1, active=traced,
                                             repeat=1)).__enter__()
    if prof is not None:
        if device.type == "cuda":
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        launches.__exit__(None, None, None)
    window_s = rounds[-1][2] - t0
    gc.unfreeze()
    run = Run(n_ch, ring.chunk, rounds, window_s, setup_s, dict(parts),
              traced + 1 if traced else 0)
    if prof is not None:
        run.trace = _trace_of(prof, launches, rounds[-traced:])
    del pool, packed
    return run, check(cell, ring.payloads, rounds, kept)


def _compact(out: list, frame_bytes: int) -> tuple:
    """A round's delivered frames as (channels, payload rows) arrays, so
    that the kept rounds add no objects for the garbage collector to scan
    (a payload of another width is kept as a row of zeros, wrong)."""
    chans = np.fromiter((ch for ch, _ in out), np.int64, len(out))
    zero = np.zeros(frame_bytes, np.uint8)
    rows = [r.payload.reshape(-1) if r.payload.size == frame_bytes else zero
            for _, r in out]
    if not rows:
        return chans, np.zeros((0, frame_bytes), np.uint8)
    return chans, np.stack(rows)


def check(cell: dict, payloads: np.ndarray, rounds: list,
          kept: dict) -> dict:
    """Each number compared, with its limit. missed_share: the share of the
    window's frames (a channel's frame a round) that no result delivered;
    wrong_share: the share of the kept rounds' delivered frames whose bytes
    differ from what the channel sent in that round, a frame delivered on
    a channel twice or on none that exists counting as wrong."""
    n_ch, n_ring = int(cell["channels"]), payloads.shape[0]
    due = n_ch * len(rounds)
    missed = due - sum(r[3] for r in rounds)
    wrong = wrong_frames = checked = 0
    for j, (chans, rows) in kept.items():
        sent = payloads[j % n_ring]
        seen = set()
        for ch, got in zip(chans.tolist(), rows):
            checked += 1
            if not 0 <= ch < n_ch or ch in seen:
                bad = sent.shape[1]
            else:
                bad = int((got != sent[ch]).sum())
            seen.add(ch)
            wrong += bad
            wrong_frames += bad > 0
    limits = cell["limits"]
    return {"missed_share": {"value": missed / due,
                             "limit": limits["missed_share"]},
            "wrong_share": {"value": wrong_frames / max(checked, 1),
                            "limit": limits["wrong_share"],
                            "frames": wrong_frames, "checked": checked,
                            "bytes": wrong}}


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the pool call that the host was in at its
    middle."""
    by = {}
    for name, s, e in tr.device_ops:
        by[name] = by.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    _, gaps = yardstick.busy_union([(s, e) for _, s, e in tr.device_ops],
                                   tr.lo, tr.hi)
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) / 2
        call = next(("round()" if mid < b else "unpack()"
                     for a, b, c in tr.phases if a <= mid <= c), "between rounds")
        named.append([call, (e - s) * 1e-6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
