#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mercury_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from mercury_tpu_torch/csrc (first use, into
build/mercury_tpu_torch/), then:
  1. holds each kernel against its plain PyTorch version at the receive
     paths' shapes (batch 256) and times both with CUDA events, the wrapper
     call and the kernel alone (a raw launch on prepared operands), beside
     the kernel's bound: the larger of its compulsory bytes over the H100's
     HBM rate and its operations over the peak rate of their type, reckoned
     from this run's inputs. mix_fir_decimate also gets a library
     yardstick: cuDNN conv1d of the real passband with pre-rotated taps,
     then one complex rotation at the output positions. mix_fir_decimate
     is held at the buffer and frame sizes of every main path (CONFIG_3
     and 0, 9, 16, 13, 11, the MFSK modes 100 and 101/102, the control
     frames of 100 and 101) and in the ACK/BREAK detector's form, with
     per-row frequency offsets (+-45 Hz: the data FIR of decode_at at
     CONFIG_0/3's, 9's and 100's sizes; the stride-1 "same" form of
     to_baseband), and in the stride-1 "same" form over CONFIG_9's buffer
     with either taps (to_baseband, measure_signal_dbm); deep_mf_score
     also at the refine shapes of CONFIG_11 (three preamble symbols), 13
     (two) and 16 (one), and at refine_decode's full-rate shape;
  2. drives the port's receive paths, TxChain.transmit -> awgn_passband ->
     RxChain.receive, with batch 256: CONFIG_3 (BPSK 4/16, noncoherent deep
     sync), CONFIG_9 (QPSK 8/16) and CONFIG_0 (BPSK 1/16, coherent deep
     acquisition) at Es/N0 12 dB; CONFIG_16 (32QAM 14/16: DD, BICM-ID, MER
     SNR) at 31 dB, CONFIG_13 (16QAM 8/16) at 17 dB, CONFIG_11 (8PSK
     8/16) at 14 dB, the MFSK modes CONFIG_100, 101, 102 at -9, -7, -4 dB
     channel SNR and the control frames of 100 and 101 at -12 and -10 dB.
     Each path runs with the launch counts set to 0 just
     before it and read just after: every row (15/16 of a control frame's)
     must decode to the payload sent, every kernel of the path must have been launched, and the first
     rows must agree with the CPU run of the same buffer (plain versions).
     CONFIG_0 runs again at -4 dB (lower until a row's first decode fails),
     where the CRC-gated rescue decode must run and 7/8 of the rows must
     decode. CONFIG_16 runs again near its threshold (21 dB, stepping down
     until a first decode fails), where BICM-ID and the decision-directed
     pass must run on the card and recover at least one row; CONFIG_100
     near its waterfall (-13 dB down), where the runner-up sync
     candidate's decode must run and lose no row. Then the ACK/BREAK
     patterns on CONFIG_0 and 100 (tests/test_patterns.py's bars), CONFIG_0
     under the three Watterson presets (FER <= 0.125) and CONFIG_9 under
     "moderate" fading with and without the link's DD chain
     (tests/test_dd.py:119's bars). Then the rest of the chain surface:
     the BER harness at 1024 frames a point, 0.5 dB either side of the
     recorded waterfalls of CONFIG_9 baseband, CONFIG_0 passband and
     CONFIG_100's control frames, and CONFIG_0's front_end_delta;
     decode_at and refine_decode over 256 CONFIG_9 rows at +20 Hz;
     cfo_range="narrow" on CONFIG_9 and 0 at +-30 Hz; measure_signal_dbm
     on noise of known power; StreamReceiver on tests/test_stream.py's
     three-frame stream; rx_diagnostics's bars;
  3. decodes the reference's CONFIG_0, 3 and 9 capture buffers, those of
     CONFIG_10-16 and 100-102 at both pilot densities, and CONFIG_15/16's
     with the zero-forcing estimator (tests/golden), to their reference
     bytes;
  4. holds each kernel shape that the paths of 2 and 3 launched and
     phase 1 did not hold against its plain version, on the operands of
     its first call there (ShapeLog, hold_path_shapes).
Any failure raises (non-zero exit). Without a CUDA device it exits non-zero
before printing a result. The line before the last lists the kernels
(launches on the main paths, error, times, bound, library time); the last
line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import inspect
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.core.modes import HIGH_DENSITY, LOW_DENSITY
from mercury_tpu_torch import native, obs
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.channel.ber import BerHarness
from mercury_tpu_torch.dsp import kernels
from mercury_tpu_torch.link import protocol as P
from mercury_tpu_torch.link.node import ArqConfig, ArqNode
from mercury_tpu_torch.link.sim import ChannelModel, LinkSimulator
from mercury_tpu_torch.link.tcp_api import ArqTcpServer
from mercury_tpu_torch.link.transport import PairTransport
from mercury_tpu_torch.modem.patterns import PatternSignaler
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.stream import StreamReceiver
from mercury_tpu_torch.modem.tx import TxChain
from mercury_tpu_torch.scale import serve

BATCH = 256
# Es/N0 (dB) of each main path: 12 dB up to QPSK, then tests/test_rx.py:64's
# clean points; of an MFSK mode the channel SNR, its waterfall + 4 dB
# (tests/test_rx.py:135), and of its control frame tests/test_mfsk_ctrl.py:14's
ESN0_DB = {3: 12.0, 9: 12.0, 0: 12.0, 16: 31.0, 13: 17.0, 11: 14.0,
           100: -9.0, 101: -7.0, 102: -4.0}
CTRL_DB = {100: -12.0, 101: -10.0}
# At the control frames' points the JAX reference itself loses rows at batch
# 256 (tools/mfsk_ctrl_reference.py: 250/256 at CONFIG_100, 255/256 at 101,
# the same rows as the port's CPU run): there 15/16 of the rows must decode.
GOLDEN = pathlib.Path(__file__).resolve().parent / "tests" / "golden"
KERNELS = {
    "mix_fir_decimate": ("mercury_tpu_torch/csrc/mix_fir_decimate.cu",
                         "mercury_tpu/dsp/pallas_kernels.py:143"),
    "deep_mf_score": ("mercury_tpu_torch/csrc/deep_mf_score.cu",
                      "mercury_tpu/dsp/pallas_kernels.py:298"),
    "deep_mf_max": ("mercury_tpu_torch/csrc/deep_mf_score.cu",
                    "mercury_tpu/dsp/pallas_kernels.py:404"),
    "pilot_cand_score": ("mercury_tpu_torch/csrc/pilot_cand_score.cu",
                         "mercury_tpu/dsp/pallas_kernels.py:573"),
}
# the kernels each receive path must launch
PATH_KERNELS = {3: ("mix_fir_decimate", "deep_mf_score"),
                9: ("mix_fir_decimate", "deep_mf_score"),
                0: ("mix_fir_decimate", "deep_mf_max", "pilot_cand_score"),
                16: ("mix_fir_decimate", "deep_mf_score"),
                13: ("mix_fir_decimate", "deep_mf_score"),
                11: ("mix_fir_decimate", "deep_mf_score"),
                100: ("mix_fir_decimate",), 101: ("mix_fir_decimate",),
                102: ("mix_fir_decimate",)}
# Es/N0 of the cfo_range="narrow" receives at +-30 Hz: at 12 dB the JAX
# chain itself loses rows (CONFIG_0: 3 of 64, CONFIG_9: 10 of 64, and 2 of
# 64 at 16 dB; the port the same rows, wide or narrow:
# tools/narrow_cfo_reference.py)
NARROW_DB = 20.0
# the chains whose data FIR phase 1 also holds with per-row offsets
# (CONFIG_3's buffer and frame sizes are CONFIG_0's)
FREQ_FORMS = ("CONFIG_3", "CONFIG_9", "CONFIG_100")
# the matched-filter kernels' tensor-core arithmetic
MF_FORM = ("TF32 one pass: wgmma m64nNk8 tf32 x tf32 -> f32 (A from "
           "registers, B from shared memory), operands rounded with cvt.rna")
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"FP32": 67e12, "TF32": 495e12}


def bound(nbytes: float, flops: float, kind: str) -> dict:
    """The least time the card could take: compulsory bytes over the HBM
    rate or operations over the peak of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "flop_kind": kind}


def bound_text(b: dict, kernel_ms: float) -> str:
    return (f"bound {b['bound_ms']:.4g} ms by {b['bound_by']} "
            f"({b['bytes'] / 1e6:.2f} MB, {b['flops'] / 1e9:.3f} GFLOP "
            f"{b['flop_kind']}); the kernel alone at "
            f"{100 * b['bound_ms'] / kernel_ms:.1f}% of it")


def mf_tflops(rows: int, bank_shape, n_cand: int, ms: float) -> float:
    """Effective TFLOP/s of a matched-filter call: 8 flops per complex
    multiply-add of the direct correlation (rows x A x lags x Lp*S), the
    GEMM's padding not counted."""
    a, lp, s = bank_shape
    return 8.0 * rows * a * n_cand * lp * s / (ms * 1e-3) / 1e12


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def raw_ms(launch, reps: int = 20) -> float:
    """Mean device time of a raw kernel launch (a C entry point of the
    kernel library on prepared operands, no torch work around it): the
    kernel alone, not its wrapper's host side."""
    err = launch()
    assert err == 0, f"launch failed: cudaError_t {err}"
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mf_bound(rows: int, seg_len: int, bank_shape, n_cand: int,
             out_bytes: int) -> dict:
    """Matched-filter bound: seg (8 B a sample), bank, outputs of out_bytes
    per (row, lag); 8 flops per complex multiply-add at the TF32 peak."""
    a, lp, s = bank_shape
    return bound(8 * rows * seg_len + 8 * a * lp * s
                 + out_bytes * rows * n_cand,
                 8.0 * rows * a * n_cand * lp * s, "TF32")


def mf_raw(name: str, seg, bank, window: int, outs):
    """A raw launch of a matched-filter kernel on _dmf_operands' operands
    (packing and prefix sums done once, outside the timing)."""
    lib = native.load_library()
    seg, tmpl, ce, ef = kernels._dmf_operands(seg, bank, window, name)
    b, seg_len = seg.shape
    a, lp, s = bank.shape
    fn = lib.dmf_launch if name == "deep_mf_score" else lib.dmf_max_launch
    operands = (seg, tmpl, ce, ef, *outs)        # alive as long as the launch
    return lambda: fn(*[t.data_ptr() for t in operands], b, a, seg_len, lp, s,
                      2 * window + 1, 8 * tmpl.shape[2], kernels._stream(seg))


def fir_raw(pb, osc, taps, stride, start=None, n_out=None, offset=None,
            freq=None, fs=None):
    """A raw launch of mix_fir_decimate on the wrapper's operands (the
    output allocated once, outside the timing)."""
    lib = native.load_library()
    b, n = pb.shape
    ntaps = taps.shape[0]
    if start is None:
        n_out, offset = (n - 1) // stride + 1, (ntaps - 1) // 2
    dst = torch.empty((b, n_out), dtype=torch.complex64, device=pb.device)
    return lambda: lib.mfd_launch(
        pb.data_ptr(), osc.data_ptr(), taps.data_ptr(),
        None if start is None else start.data_ptr(),
        None if freq is None else freq.data_ptr(),
        0.0 if freq is None else float(fs), dst.data_ptr(), b, n, n_out,
        stride, offset, ntaps, kernels._stream(pb))


def pcs_raw(bb_dec, idx0, fidx, bank, prepared=None):
    """A raw launch of pilot_cand_score on the wrapper's operands (the
    baseband at its own strides; the kernel clips the candidates)."""
    lib = native.load_library()
    b, n_dec = bb_dec.shape
    m = idx0.shape[1]
    f_n, nsym, s_d = bank.shape
    bank_t, e_t = prepared or kernels.pilot_bank(bank)
    res = torch.empty((b, m), dtype=torch.float32, device=bb_dec.device)
    operands = (bb_dec, idx0.long().contiguous(), fidx.long().contiguous(),
                bank_t, e_t, res)
    return lambda: lib.pcs_launch(
        *[t.data_ptr() for t in operands], b, n_dec, bb_dec.stride(0),
        bb_dec.stride(1), m, f_n, nsym, s_d, kernels._stream(bb_dec))


def pcs_bound(bb_dec, idx0, fidx, bank) -> dict:
    """pilot_cand_score's bound. Bytes: each row's samples under some
    candidate, the bank rows referenced, starts, rows, energies and scores;
    flops: 8 per complex multiply-add and 4 per sample energy (FP32)."""
    b, n_dec = bb_dec.shape
    m = idx0.shape[1]
    _, nsym, s_d = bank.shape
    span = nsym * s_d
    st, fr = kernels._clip_candidates(n_dec, idx0, fidx, bank)
    cover = torch.zeros((b, n_dec + 1), dtype=torch.int32,
                        device=bb_dec.device)
    one = torch.ones_like(st, dtype=torch.int32)
    cover.scatter_add_(1, st, one)
    cover.scatter_add_(1, st + span, -one)
    row_samples = int((cover.cumsum(1)[:, :n_dec] > 0).sum())
    n_rows_used = int(torch.unique(fr).numel())
    return {**bound(8 * row_samples + 8 * n_rows_used * span + 16 * b * m
                    + 4 * nsym + 4 * b * m, 12.0 * b * m * span, "FP32"),
            "bank_rows": n_rows_used}


def shape_key(name: str, a: dict) -> tuple:
    """What a kernel launch's grid and memory walk depend on, from its
    wrapper's arguments: the operands' shapes (and the baseband's strides
    for pilot_cand_score, which reads a strided view) and the integer
    parameters."""
    if name == "mix_fir_decimate":
        b, n = a["pb"].shape
        ntaps = a["taps"].shape[0]
        if a["start"] is None:
            n_out, offset = (n - 1) // a["stride"] + 1, (ntaps - 1) // 2
        else:
            n_out, offset = a["n_out"], a["offset"]
        return (b, n, n_out, a["stride"], offset, ntaps,
                "starts" if a["start"] is not None else "from 0",
                "offsets" if a["freq"] is not None else "no offsets")
    if name == "pilot_cand_score":
        bb = a["bb_dec"]
        return (*bb.shape, *bb.stride(), a["idx0"].shape[1],
                *a["bank"].shape)
    return (*a["seg"].shape, *a["bank"].shape, a["window"])


def _copy(v):
    """A tensor copied at its own strides (a tuple of them each), else v."""
    if isinstance(v, tuple):
        return tuple(_copy(x) for x in v)
    if not torch.is_tensor(v):
        return v
    return torch.empty_strided(v.shape, v.stride(), dtype=v.dtype,
                               device=v.device).copy_(v)


class ShapeLog:
    """The launch shapes of the four kernels. Each wrapper in `kernels` is
    replaced by one that notes the shape (shape_key) of every call on the
    card, then calls the wrapper (whose launch count is its own). While
    `path` is None (phase 1) a shape is noted as held against the plain
    version; on a path, every shape's launches are counted, and a shape
    phase 1 did not hold keeps the first path to launch it and a copy of
    its first call's operands, which hold_path_shapes holds against the
    plain version."""

    def __init__(self):
        self.wrappers = {name: getattr(kernels, name) for name in KERNELS}
        self.held = set()
        self.path = None
        self.unheld = {}
        self.launches = {}
        for name, fn in self.wrappers.items():
            setattr(kernels, name, self._noting(name, fn))

    def _noting(self, name, fn):
        sig = inspect.signature(fn)

        def noted(*args, **kw):
            a = sig.bind(*args, **kw)
            a.apply_defaults()
            if a.args[0].is_cuda:
                self.note(name, a.arguments)
            return fn(*args, **kw)
        return noted

    def note(self, name: str, a: dict) -> None:
        key = (name, shape_key(name, a))
        if self.path is None:
            self.held.add(key)
            return
        self.launches[key] = self.launches.get(key, 0) + 1
        if key not in self.held and key not in self.unheld:
            self.unheld[key] = {"path": self.path,
                                "args": {k: _copy(v) for k, v in a.items()}}


def hold_path_shapes(log: ShapeLog) -> dict:
    """Every shape a path launched that phase 1 did not hold, on the
    operands of its first call there: the wrapper against the plain
    version at phase 1's tolerances (mix_fir_decimate within 1e-4 of
    max(1, the output's scale); the matched filters rtol and atol 1e-3,
    with the argmax equal wherever the plain version's top two differ by
    more than 1e-3; pilot_cand_score rtol 1e-4, atol 1e-5), each timed
    through the wrapper, alone and plain (5 launches each) beside its
    bound. -> {"name shape": figures}."""
    out = {}
    for (name, key), entry in sorted(log.unheld.items(), key=str):
        a = entry["args"]
        wrapper, plain = log.wrappers[name], getattr(kernels, f"{name}_ref")
        pa = {k: v for k, v in a.items() if k != "prepared"}
        if name == "mix_fir_decimate":
            got, want = wrapper(**a), plain(**pa)
            err = (got - want).abs().max().item()
            limit = 1e-4 * max(1.0, want.abs().max().item())
            assert err <= limit, f"{name} {key}: max abs err {err}"
            b, n, n_out, stride, offset, ntaps = key[:6]
            start = a["start"] if a["start"] is not None else torch.zeros(
                b, dtype=torch.int64, device=a["pb"].device)
            bd = fir_bound(b, n, start, n_out, stride, offset, ntaps,
                           a["freq"] is not None)
            raw = fir_raw(**a)
            text = f"within {limit:.3e}"
        elif name == "pilot_cand_score":
            got, want = wrapper(**a), plain(**pa)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
            err = (got - want).abs().max().item()
            bd = pcs_bound(a["bb_dec"], a["idx0"], a["fidx"], a["bank"])
            raw = pcs_raw(**a)
            text = "within rtol 1e-4, atol 1e-5"
        else:
            seg, bank, window = a["seg"], a["bank"], a["window"]
            score = kernels.deep_mf_score_ref(seg, bank, window)
            if name == "deep_mf_score":
                got, want = wrapper(**a), score
                outs = [torch.empty_like(got)]
            else:
                (got, sarg), (want, ref_arg) = wrapper(**a), plain(**pa)
                outs = [torch.empty_like(got), torch.empty_like(sarg)]
                top2 = score.topk(2, dim=1).values
                clear = top2[:, 0] - top2[:, 1] > 1e-3
                assert torch.equal(sarg[clear], ref_arg[clear]), (
                    f"{name} {key}: sarg differs at a clear lag")
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
            top2 = want.topk(2, dim=-1).values
            clear = top2[..., 0] - top2[..., 1] > 1e-3
            assert torch.equal(got.argmax(-1)[clear], want.argmax(-1)[clear]), (
                f"{name} {key}: argmax over lags differs")
            err = (got - want).abs().max().item()
            bd = mf_bound(seg.shape[0], seg.shape[1], bank.shape,
                          2 * window + 1, 4 if name == "deep_mf_score" else 12)
            raw = mf_raw(name, seg, bank, window, outs)
            text = (f"within rtol/atol 1e-3, argmax equal on "
                    f"{int(clear.sum())}/{clear.numel()} clear rows")
        st = {"launches": log.launches[name, key], "path": entry["path"],
              "max_abs_err": err, "ms": cuda_ms(lambda: wrapper(**a), 5),
              "kernel_ms": raw_ms(raw, 5),
              "plain_ms": cuda_ms(lambda: plain(**pa), 5), **bd}
        out[f"{name} {key}"] = st
        print(f"path shape {name} {list(key)} (first launched by "
              f"{entry['path']}; {st['launches']} launches on the "
              f"paths): max abs err {err:.3e} {text}; wrapper "
              f"{st['ms']:.4f} ms, kernel alone {st['kernel_ms']:.4f} ms, "
              f"plain {st['plain_ms']:.4f} ms; "
              f"{bound_text(bd, st['kernel_ms'])}")
    return out


def golden(name: str) -> np.ndarray:
    meta = {}
    for f in sorted(GOLDEN.glob("meta*.json")):
        meta.update(json.loads(f.read_text()))
    info = meta[name]
    return np.fromfile(GOLDEN / f"{name}.bin",
                       dtype=np.dtype(info["dtype"])).reshape(info["shape"])


def fir_window_samples(n: int, start: torch.Tensor, n_out: int,
                       stride: int, offset: int, ntaps: int):
    """(passband samples the FIR reads over all rows, oscillator samples it
    reads once): each row's input window clipped to [0, n)."""
    lo = torch.clamp(start + offset - (ntaps - 1), 0, n)
    hi = torch.clamp(start + offset + (n_out - 1) * stride + 1, 0, n)
    used = torch.zeros(n + 1, dtype=torch.int32, device=start.device)
    used.index_add_(0, lo, torch.ones_like(lo, dtype=torch.int32))
    used.index_add_(0, hi, -torch.ones_like(hi, dtype=torch.int32))
    return int((hi - lo).sum()), int((used.cumsum(0)[:n] > 0).sum())


def fir_bound(b: int, n: int, start, n_out: int, stride: int, offset: int,
              ntaps: int, freq: bool = False) -> dict:
    """Bytes: the passband windows (4 B), the oscillator over their union
    (8 B), taps, per-row offsets (4 B), output (8 B); flops: 2 per sample
    mixed (8 with a per-row offset: the complex product of the oscillator
    and the rotation too; the sine and cosine, special-function work, are
    not counted), 4 per tap of an output (FP32)."""
    pb_n, osc_n = fir_window_samples(n, start, n_out, stride, offset, ntaps)
    return bound(4 * pb_n + 8 * osc_n + 4 * ntaps + 8 * b * n_out
                 + (4 * b if freq else 0),
                 (8 if freq else 2) * pb_n + 4 * b * n_out * ntaps, "FP32")


def fir_library(pb, _osc, taps, stride, g):
    """One PyTorch call for the TS FIR: cuDNN conv1d of the real passband
    with the taps pre-rotated by e^{-jwj} (float64, 2 output channels:
    Re, Im), then the oscillator's rotation sqrt(2) e^{jw(m*stride + c)} at
    each output m, c the 'same' centre. (TF32 is off for cuDNN.)"""
    ntaps = taps.shape[0]
    c = (ntaps - 1) // 2
    w = 2 * np.pi * g.fc / g.fs
    rot_taps = (taps.double().cpu().numpy()
                * np.exp(-1j * w * np.arange(ntaps)))[::-1]
    weight = torch.as_tensor(np.stack([rot_taps.real, rot_taps.imag])[:, None],
                             dtype=torch.float32, device=pb.device)
    n_out = (pb.shape[1] - 1) // stride + 1
    ph = w * (np.arange(n_out, dtype=np.float64) * stride + c)
    rot = torch.as_tensor((np.sqrt(2.0) * np.exp(1j * ph)).astype(np.complex64),
                          device=pb.device)

    def run():
        y = torch.nn.functional.conv1d(pb[:, None], weight, stride=stride,
                                       padding=ntaps - 1 - c)
        return torch.complex(y[:, 0], y[:, 1]) * rot
    return run


def check_mix_fir_decimate(chains: dict, gen: torch.Generator,
                           pattern: PatternSignaler, small: dict) -> dict:
    """For each main path's chain (label -> chain; CONFIG_3 first, whose
    numbers go into the kernels line): the TS form over the whole buffer,
    stride 4, and the per-row-start data-FIR form of that mode's frame
    (a control-frame chain: its frame only, its buffer is its data
    chain's), against the plain version: max abs error <= 1e-4. Then the
    pattern detector's "same" form (stride 4, the data taps) over an
    ACK/BREAK buffer of `pattern`'s geometry. Each timed through the
    wrapper and as the kernel alone, beside its bound; the "same" forms also
    beside the conv1d yardstick (which must agree within 1e-4). Then the
    link's sizes for each chain in `small` (label -> chain): the TS and
    data FIRs at batch 1 (a node's receive) and the data FIR with per-row
    offsets at batch 5 (refine_decode of a batch_size-5 block's siblings).
    The TS form without per-row starts puts two rows in a block: batch 1
    holds its odd tail."""
    out = {"max_abs_err": 0.0, "paths": {}}

    def offsets(b):
        """Per-row frequency offsets, uniform in +-45 Hz (float32 [b])."""
        return (torch.rand(b, generator=gen, device=dev) - 0.5) * 90.0

    def same_form(label, pb, osc, taps, g, stride=None, freq=False):
        """The strided "same" form (every row from 0) of pb [b, n],
        stride g.interp unless given; freq: with per-row offsets (held to
        1e-4 of the output scale; no library call takes them)."""
        b, n = pb.shape
        ntaps = taps.shape[0]
        stride = stride or g.interp
        args = (pb, osc, taps, stride)
        kw = dict(freq=offsets(b), fs=g.fs) if freq else {}
        want = kernels.mix_fir_decimate_ref(*args, **kw)
        err = (kernels.mix_fir_decimate(*args, **kw) - want).abs().max().item()
        limit = 1e-4 * (want.abs().max().item() if freq else 1.0)
        assert err <= limit, f"{label}: max abs err {err} (limit {limit})"
        del want
        n_out = (n - 1) // stride + 1
        st = {"max_abs_err": err, "n_ts": n_out,
              "ms": cuda_ms(lambda: kernels.mix_fir_decimate(*args, **kw)),
              "kernel_ms": raw_ms(fir_raw(*args, **kw)),
              "plain_ms": cuda_ms(lambda: kernels.mix_fir_decimate_ref(
                  *args, **kw)),
              "library_ms": None}
        lib_text = "library: none (per-row offsets)"
        if not freq:
            library = fir_library(*args, g)
            lib_err = (library() - kernels.mix_fir_decimate(*args)).abs().max(
                ).item()
            assert lib_err <= 1e-4, (
                f"{label}: conv1d yardstick differs by {lib_err}")
            st["library_ms"] = cuda_ms(library)
            lib_text = (f"library (two calls: cuDNN conv1d [{b},1,{n}] x "
                        f"[2,1,{ntaps}] stride {stride}, then torch.complex * "
                        f"rotation) {st['library_ms']:.4f} ms, agrees within "
                        f"{lib_err:.3e}")
        st.update(fir_bound(b, n, torch.zeros(b, dtype=torch.int64,
                                               device=pb.device),
                            n_out, stride, (ntaps - 1) // 2, ntaps, freq))
        print(f"mix_fir_decimate {label} [{b},{n}] s{stride} -> "
              f"[{b},{n_out}]: max abs err {err:.3e} (limit "
              f"{limit:.3e}); wrapper {st['ms']:.4f} ms, kernel alone "
              f"{st['kernel_ms']:.4f} ms, plain {st['plain_ms']:.4f} ms; "
              f"{bound_text(st, st['kernel_ms'])}; {lib_text}")
        return st

    def data_form(label, pb, osc, rx, freq=False):
        """The per-row-start data FIR of rx's frame (active_nsymb); freq:
        with per-row offsets (held to 1e-4 of the output scale)."""
        g = rx.geom
        b, n = pb.shape
        ntaps = rx._fir_data.shape[0]
        frame = g.nofdm * (rx.active_nsymb + g.preamble_nsymb) * g.interp
        start = torch.randint(0, n - frame, (b,), generator=gen,
                              device=pb.device)
        row = dict(start=start, n_out=frame // g.interp,
                   offset=ntaps - 1 - (ntaps - 1) // 2)
        if freq:
            row.update(freq=offsets(b), fs=g.fs)
        data = (pb, osc, rx._fir_data, g.interp)
        want = kernels.mix_fir_decimate_ref(*data, **row)
        err = (kernels.mix_fir_decimate(*data, **row) - want).abs().max().item()
        limit = 1e-4 * (want.abs().max().item() if freq else 1.0)
        assert err <= limit, f"{label} data FIR: max abs err {err}"
        del want
        bd = fir_bound(b, n, start, row["n_out"], g.interp, row["offset"],
                       ntaps, freq)
        st = {"data_err": err, "n_data": row["n_out"],
              "data_ms": cuda_ms(lambda: kernels.mix_fir_decimate(*data,
                                                                  **row)),
              "data_kernel_ms": raw_ms(fir_raw(*data, **row)),
              "data_plain_ms": cuda_ms(
                  lambda: kernels.mix_fir_decimate_ref(*data, **row)),
              "data_bound_ms": bd["bound_ms"]}
        print(f"mix_fir_decimate {label} data FIR -> [{b},{row['n_out']}] "
              f"at per-row starts{' and offsets (+-45 Hz)' if freq else ''}: "
              f"max abs err {err:.3e} (limit {limit:.3e}); "
              f"wrapper {st['data_ms']:.4f} ms, kernel alone "
              f"{st['data_kernel_ms']:.4f} ms, plain "
              f"{st['data_plain_ms']:.4f} ms; "
              f"{bound_text(bd, st['data_kernel_ms'])}; library: none "
              f"(per-row starts)")
        return st

    dev = next(iter(chains.values())).device
    buffers = {}
    for label, rx in chains.items():
        g = rx.geom
        n = g.nofdm * g.buffer_nsymb * g.interp
        if n not in buffers:            # a control frame shares its buffer
            buffers[n] = 0.3 * torch.randn((BATCH, n), generator=gen,
                                           device=rx.device)
        pb, osc = buffers[n], rx._osc_const(n)
        st = {} if rx.ctrl else same_form(f"{label} TS", pb, osc, rx._fir_ts,
                                          g)
        st.update(data_form(label, pb, osc, rx))
        st["max_abs_err"] = max(st.get("max_abs_err", 0.0), st["data_err"])
        if not out["paths"]:
            out.update(st)
        out["max_abs_err"] = max(out["max_abs_err"], st["max_abs_err"])
        out["paths"][label] = st
        # the forms of decode_at, refine_decode, to_baseband and
        # measure_signal_dbm: the data FIR with per-row offsets (CONFIG_9,
        # 0, 100), the stride-1 "same" form with either taps (CONFIG_9) and
        # with per-row offsets (rx_diagnostics)
        new = {}
        if label in FREQ_FORMS:
            new[f"{label} offsets"] = data_form(f"{label}", pb, osc, rx,
                                                freq=True)
        if label == "CONFIG_9":
            for name, taps in (("TS", rx._fir_ts), ("data", rx._fir_data)):
                new[f"{label} s1 {name}"] = same_form(
                    f"{label} s1 {name} taps", pb, osc, taps, g, stride=1)
            new[f"{label} s1 TS offsets"] = same_form(
                f"{label} s1 TS taps, offsets (+-45 Hz)", pb, osc, rx._fir_ts,
                g, stride=1, freq=True)
        for key, st in new.items():
            err = st.get("data_err", st.get("max_abs_err"))
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["paths"][key] = st
        del pb, osc
    buffers.clear()
    # the ACK/BREAK detector: both patterns with noise, two symbols in
    g = pattern.geom
    delay = 2 * g.nofdm * g.interp
    n = pattern.passband_samples + 2 * delay
    pb = 0.05 * torch.randn((BATCH, n), generator=gen, device=pattern.device)
    for i, wave in enumerate((pattern.ack_passband, pattern.break_passband)):
        pb[i::2, delay: delay + wave.size] += torch.as_tensor(
            wave, dtype=torch.float32, device=pattern.device)
    label = f"pattern CONFIG_{g.spec.config}"
    st = same_form(f"{label} same form, data taps", pb, pattern._osc(n),
                   pattern._fir_data, g)
    out["max_abs_err"] = max(out["max_abs_err"], st["max_abs_err"])
    out["paths"][label] = st
    del pb
    for label, rx in small.items():
        g = rx.geom
        n = g.nofdm * g.buffer_nsymb * g.interp
        pb5 = 0.3 * torch.randn((5, n), generator=gen, device=rx.device)
        osc = rx._osc_const(n)
        st = same_form(f"{label} TS, batch 1", pb5[:1], osc, rx._fir_ts, g)
        st.update(data_form(f"{label} batch 1", pb5[:1], osc, rx))
        st5 = data_form(f"{label} batch 5", pb5, osc, rx, freq=True)
        out["paths"][f"{label} batch 1"] = st
        out["paths"][f"{label} offsets batch 5"] = st5
        out["max_abs_err"] = max(out["max_abs_err"], st["max_abs_err"],
                                 st["data_err"], st5["data_err"])
    return out


def check_deep_mf_score(rx: RxChain, gen: torch.Generator,
                        refine_only: dict, rx9: RxChain) -> dict:
    """Whole-buffer scan [256,14824]x[9,4,136] w=7140 and per-candidate
    refine [768,1088]x[3,4,136] w=272 (CONFIG_3, and CONFIG_9's refine),
    the refine of each chain in refine_only (label -> chain: CONFIG_11
    [768,952]x[3,3,136], CONFIG_13 [768,816]x[3,2,136], CONFIG_16
    [768,680]x[3,1,136]), and refine_decode's full-rate shape on rx9
    (CONFIG_9: [256,4864]x[1,4,1088] w=256, 513 lags: not a multiple of
    the kernel's 256-lag tile); and the link's sizes: a batch-1 receive's
    refine ([3,1088]x[3,4,136]) and refine_decode over a batch_size-5
    block's siblings ([5,4864]x[1,4,1088]); with planted peaks: argmax
    equal on every planted row, scores within rtol 1e-3 (atol 1e-3)."""
    dev = rx.device
    aliases = (0.0, 93.75, -93.75)
    out = {"max_abs_err": 0.0, "shapes": {}}
    for label, chain, rows, freqs, window in (
            ("scan", rx, BATCH, np.arange(-4, 5) * 30.0, 7140),
            ("refine", rx, 3 * BATCH, aliases, 272),
            *((f"refine {name}", c, 3 * BATCH, aliases, 272)
              for name, c in refine_only.items()),
            ("refine_decode CONFIG_9", rx9, BATCH, None, 256),
            ("refine, batch 1", rx, 3, aliases, 272),
            ("refine_decode CONFIG_9, batch 5", rx9, 5, None, 256)):
        if freqs is None:               # the full-rate templates as they are
            bank = chain._mf_templates[None]
            lp, s = bank.shape[1:]
        else:
            tmpl = chain._mf_templates[:, ::8]
            lp, s = tmpl.shape
            bank = rx._rotated_bank(tmpl, freqs, 8)
        seg_len = 2 * window + lp * s
        seg = torch.complex(torch.randn((rows, seg_len), generator=gen,
                                        device=dev),
                            torch.randn((rows, seg_len), generator=gen,
                                        device=dev)) * 0.05
        hyp = torch.randint(0, bank.shape[0], (rows,), generator=gen,
                            device=dev)
        lag = torch.randint(0, 2 * window + 1, (rows,), generator=gen,
                            device=dev)
        idx = lag[:, None] + torch.arange(lp * s, device=dev)[None]
        seg.scatter_add_(1, idx, bank[hyp].reshape(rows, -1))
        got = kernels.deep_mf_score(seg, bank, window)
        want = kernels.deep_mf_score_ref(seg, bank, window)
        r = torch.arange(rows, device=dev)
        got_arg = got.argmax(-1)[r, hyp]
        want_arg = want.argmax(-1)[r, hyp]
        assert torch.equal(got_arg, want_arg) and torch.equal(got_arg, lag), (
            f"{label}: argmax differs on "
            f"{int((got_arg != want_arg).sum())} planted rows")
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
        err = (got - want).abs().max().item()
        out["max_abs_err"] = max(out["max_abs_err"], err)
        k_ms = cuda_ms(lambda: kernels.deep_mf_score(seg, bank, window), 5)
        raw = raw_ms(mf_raw("deep_mf_score", seg, bank, window,
                            [torch.empty_like(got)]), 5)
        p_ms = cuda_ms(lambda: kernels.deep_mf_score_ref(seg, bank, window), 5)
        bd = mf_bound(rows, seg_len, bank.shape, 2 * window + 1, 4)
        if label == "scan":
            out.update(bd, ms=k_ms, kernel_ms=raw, plain_ms=p_ms)
        elif label == "refine":
            out.update(refine_ms=k_ms, refine_kernel_ms=raw,
                       refine_plain_ms=p_ms, refine_bound_ms=bd["bound_ms"])
        out["shapes"][label] = {"ms": k_ms, "kernel_ms": raw,
                                "plain_ms": p_ms, "bound_ms": bd["bound_ms"],
                                "max_abs_err": err}
        print(f"deep_mf_score {label} [{rows},{seg_len}]x{list(bank.shape)} "
              f"w={window}: max abs err {err:.3e}, argmax equal on {rows} "
              f"planted rows; wrapper {k_ms:.4f} ms, kernel alone "
              f"{raw:.4f} ms, plain {p_ms:.4f} ms; "
              f"{mf_tflops(rows, bank.shape, 2 * window + 1, raw):.2f} "
              f"TFLOP/s effective (kernel alone); {bound_text(bd, raw)}; "
              f"library: none; {MF_FORM}")
    out["library_ms"] = None
    return out


def check_deep_mf_max(rx: RxChain, gen: torch.Generator,
                      batch: int = BATCH) -> dict:
    """Coherent scan [batch,14824]x[61,1,544] w=7140 (batch 256: the
    receive's; 1: a link node's) with one planted peak per row: smax within
    rtol/atol 1e-3; sarg equal on every planted lag and wherever the plain
    top-two margin exceeds 1e-3; argmax over lags equal on every planted
    row."""
    dev = rx.device
    _, bank, _, _ = rx._coherent_banks(8)
    window = 7140
    seg_len = 2 * window + bank.shape[-1]
    seg = torch.complex(torch.randn((batch, seg_len), generator=gen,
                                    device=dev),
                        torch.randn((batch, seg_len), generator=gen,
                                    device=dev)) * 0.05
    hyp = torch.randint(0, bank.shape[0], (batch,), generator=gen, device=dev)
    lag = torch.randint(0, 2 * window + 1, (batch,), generator=gen,
                        device=dev)
    idx = lag[:, None] + torch.arange(bank.shape[-1], device=dev)[None]
    seg.scatter_add_(1, idx, bank[hyp, 0])
    smax, sarg = kernels.deep_mf_max(seg, bank, window)
    ref_max, ref_arg = kernels.deep_mf_max_ref(seg, bank, window)
    torch.testing.assert_close(smax, ref_max, rtol=1e-3, atol=1e-3)
    r = torch.arange(batch, device=dev)
    assert torch.equal(sarg[r, lag], hyp) and torch.equal(ref_arg[r, lag], hyp)
    assert torch.equal(smax.argmax(-1), lag) and torch.equal(
        ref_max.argmax(-1), lag), "deep_mf_max: argmax over lags differs"
    top2 = kernels.deep_mf_score_ref(seg, bank, window).topk(2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > 1e-3
    n_diff = int((sarg != ref_arg)[clear].sum())
    assert n_diff == 0, f"deep_mf_max: sarg differs at {n_diff} clear lags"
    err = (smax - ref_max).abs().max().item()
    out = {"max_abs_err": err,
           "ms": cuda_ms(lambda: kernels.deep_mf_max(seg, bank, window), 5),
           "kernel_ms": raw_ms(mf_raw("deep_mf_max", seg, bank, window,
                                      [torch.empty_like(smax),
                                       torch.empty_like(sarg)]), 5),
           "plain_ms": cuda_ms(
               lambda: kernels.deep_mf_max_ref(seg, bank, window), 5),
           "library_ms": None}
    out.update(mf_bound(batch, seg_len, bank.shape, 2 * window + 1, 12))
    print(f"deep_mf_max [{batch},{seg_len}]x{list(bank.shape)} w={window}: "
          f"max abs err {err:.3e}; sarg equal on {batch} planted lags and "
          f"{int(clear.sum())}/{clear.numel()} lags with a clear margin; "
          f"wrapper {out['ms']:.4f} ms, kernel alone {out['kernel_ms']:.4f} "
          f"ms, plain {out['plain_ms']:.4f} ms; "
          f"{mf_tflops(batch, bank.shape, 2 * window + 1, out['kernel_ms']):.2f}"
          f" TFLOP/s effective (kernel alone); "
          f"{bound_text(out, out['kernel_ms'])}; library: none; {MF_FORM}")
    return out


def check_pilot_cand_score(rx: RxChain, gen: torch.Generator,
                           batch: int = BATCH) -> dict:
    """[batch,14824] rows (256: the receive's; 1: a link node's), M=32,
    bank [61,48,136]: row 1 half-silent, row 2 silent (where batch has
    them), candidates clipped at both ends; rtol 1e-4, atol 1e-5. The
    prepared bank comes from the chain's cache, as on the path."""
    dev = rx.device
    _, _, bank, prepared = rx._coherent_banks(8)
    n_dec, m = 14824, 32
    f_n, nsym, s_d = bank.shape
    span = nsym * s_d
    bb = torch.complex(torch.randn((batch, n_dec), generator=gen, device=dev),
                       torch.randn((batch, n_dec), generator=gen, device=dev))
    if batch > 2:
        bb[1, n_dec // 2:] = 0
        bb[2] = 0
    idx0 = torch.randint(0, n_dec - span + 1, (batch, m), generator=gen,
                         device=dev)
    idx0[:, 0] = -100
    idx0[:, 1] = n_dec
    fidx = torch.randint(0, f_n, (batch, m), generator=gen, device=dev)
    args = (bb, idx0, fidx, bank)
    got = kernels.pilot_cand_score(*args, prepared)
    want = kernels.pilot_cand_score_ref(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert (got[0] > 0).all() and (batch < 3 or (got[2] == 0).all())
    err = (got - want).abs().max().item()
    out = {"max_abs_err": err,
           "ms": cuda_ms(lambda: kernels.pilot_cand_score(*args, prepared)),
           "kernel_ms": raw_ms(pcs_raw(*args, prepared)),
           "plain_ms": cuda_ms(lambda: kernels.pilot_cand_score_ref(*args)),
           "library_ms": None}
    out.update(pcs_bound(*args))
    print(f"pilot_cand_score [{batch},{n_dec}] M={m} x{list(bank.shape)}: "
          f"max abs err {err:.3e} "
          f"({'bursty, silent and clipped' if batch > 2 else 'clipped'} "
          f"cases); "
          f"wrapper {out['ms']:.4f} ms, kernel alone {out['kernel_ms']:.4f} "
          f"ms, plain {out['plain_ms']:.4f} ms; "
          f"{bound_text(out, out['kernel_ms'])} ({out['bank_rows']} bank rows "
          f"referenced; templates read per (row, candidate): "
          f"{8 * batch * m * span / 1e6:.1f} MB); library: none")
    return out


def make_buffer(g, dev: torch.device, esn0: float, seed: int,
                ctrl: bool = False, fading: dict | None = None):
    """BATCH frames of random payloads in white noise at Es/N0 esn0, at the
    bench.py delay; an MFSK mode's at a symbol-aligned delay, esn0 then the
    channel SNR (sim.sigma_for_channel_snr). fading: Watterson parameters
    applied to the frames before the noise (host numpy, seed 42)."""
    tx = TxChain(g, device=dev, ctrl=ctrl)
    gen = torch.Generator(device=dev).manual_seed(seed)
    payload = torch.randint(0, 256, (BATCH, g.frame_bytes), generator=gen,
                            device=dev, dtype=torch.uint8)
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
                                 dtype=torch.float32, device=dev)
    buf = sim.awgn_passband(frames, sigma, delay, buf_len, gen)
    return buf, payload, delay


def drive_main_path(cfg: int, dev: torch.device, ctrl: bool = False) -> dict:
    """TX -> AWGN -> RX at batch 256; every row must decode to its payload
    and every kernel of the path must launch (counts from 0 for this run).
    ctrl: an MFSK control frame at CTRL_DB."""
    g = build_geometry(cfg)
    rx = RxChain(g, device=dev, ctrl=ctrl)
    snr = CTRL_DB[cfg] if ctrl else ESN0_DB[cfg]
    label = f"CONFIG_{cfg}{' ctrl' if ctrl else ''}"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf, payload, delay = make_buffer(g, dev, snr, cfg, ctrl)
    torch.cuda.synchronize()
    t_tx = time.perf_counter() - t0
    times = []
    kernels.reset_launch_counts()
    for _ in range(4):              # first call: cuFFT plans, caches
        t0 = time.perf_counter()
        res = rx.receive(buf)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    ok = res.crc_ok
    n_ok = int(ok.sum())
    assert n_ok >= (BATCH * 15 // 16 if ctrl else BATCH), (
        f"{label}: only {n_ok}/{BATCH} rows decoded")
    assert torch.equal(res.payload[ok], payload[ok]), (
        f"{label}: payload differs")
    assert all(launches[k] > 0 for k in PATH_KERNELS[cfg]), (
        f"{label}: launches {launches}")
    assert torch.isfinite(res.snr_db).all() and torch.isfinite(
        res.freq_offset).all()
    assert (res.delay[ok] - delay).abs().max().item() <= g.ngi * g.interp
    # the first rows of the same buffer through the CPU plain versions
    rx_cpu = RxChain(g, device="cpu", ctrl=ctrl)
    ref = rx_cpu.receive(buf[:4].cpu())
    assert torch.equal(ref.crc_ok, res.crc_ok[:4].cpu())
    assert torch.equal(ref.delay, res.delay[:4].cpu())
    assert torch.equal(ref.payload, res.payload[:4].cpu())
    assert (ref.iters - res.iters[:4].cpu()).abs().max().item() <= 1
    t_rx = min(times[1:])
    buf_len = buf.shape[1]
    msps = BATCH * buf_len / t_rx / 1e6
    print(f"{label} at {snr} dB: {n_ok}/{BATCH} decoded, "
          f"payloads equal, snr mean {res.snr_db.mean().item():.3f} dB; "
          f"transmit + "
          f"channel {t_tx * 1e3:.2f} ms; receive first {times[0] * 1e3:.2f} "
          f"ms, steady {t_rx * 1e3:.2f} ms (min of {len(times) - 1}) = "
          f"{msps:.3f} Msamples/s; iters mean "
          f"{res.iters.double().mean().item():.3f}; launches {launches} "
          f"over {len(times)} receives; CPU plain run agrees on rows 0-3")
    return {"receive_ms": t_rx * 1e3, "msamples_per_s": msps,
            "launches": launches}


def drive_rescue(dev: torch.device) -> dict:
    """CONFIG_0 at batch 256 at -4 dB (tests/test_rx.py:96-123's point), or
    lower until some row's first decode fails: the rescue decode must run
    and at least 7/8 of the rows must decode to their payloads."""
    g = build_geometry(0)
    rx = RxChain(g, device=dev)
    for esn0 in (-4.0, -5.0, -6.0):
        buf, payload, delay = make_buffer(g, dev, esn0, 100)
        with torch.no_grad():
            d1, cfo1, metric, _ = rx._acquire(buf)
            first_ok = rx._decode_from(buf, d1, cfo1, metric).crc_ok
        if not bool(first_ok.all()):
            break
        print(f"CONFIG_0 at {esn0} dB: every first decode passed, going lower")
    assert not bool(first_ok.all()), "no first decode failed down to -6 dB"
    at_start = (d1 - delay).abs() <= g.ngi * g.interp
    kernels.reset_launch_counts()
    res = rx.receive(buf)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    ok = res.crc_ok
    n_ok = int(ok.sum())
    rescued = int((ok & ~first_ok).sum())
    assert n_ok * 8 >= 7 * BATCH, f"CONFIG_0 at {esn0} dB: {n_ok}/{BATCH}"
    assert torch.equal(res.payload[ok], payload[ok])
    assert all(launches[k] > 0 for k in PATH_KERNELS[0]), launches
    # two decodes: the first, and the rescue at the runner-up candidate
    assert launches["mix_fir_decimate"] == 3, launches
    print(f"CONFIG_0 at {esn0} dB: {n_ok}/{BATCH} decoded, payloads equal; "
          f"first decode failed on {int((~first_ok).sum())} rows "
          f"({int((~first_ok & at_start).sum())} of them at the true start), "
          f"the rescue decode ran and recovered {rescued}; launches "
          f"{launches}")
    return {"launches": launches}


def drive_near_threshold(dev: torch.device) -> dict:
    """CONFIG_16 at batch 256 at 21 dB, stepping down until some row's
    first decode fails (a chain with DD and BICM-ID off) and, with the
    defaults, BICM-ID and the DD pass both run: at least one row must be
    recovered by them, and every row that decodes carries its payload."""
    g = build_geometry(16)
    rx = RxChain(g, device=dev)
    plain = RxChain(g, device=dev, dd=False, bicm_iters=0)
    for esn0 in (21.0, 20.5, 20.0, 19.5, 19.0):
        buf, payload, _delay = make_buffer(g, dev, esn0, 160)
        first_ok = plain.receive(buf).crc_ok
        rx.reset_recovery()
        kernels.reset_launch_counts()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            res = rx.receive(buf)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = dict(kernels.LAUNCHES)
        rec = {k: v // 2 for k, v in rx.recovery.items()}
        recovered = int((res.crc_ok & ~first_ok).sum())
        if rec["bicm_rows"] and rec["dd_rows"] and recovered:
            break
        print(f"CONFIG_16 at {esn0} dB: {int((~first_ok).sum())} first "
              f"decodes failed, recovery {rec}, recovered {recovered}; "
              f"going lower")
    assert rec["bicm_rows"] and rec["dd_rows"] and recovered, (
        "CONFIG_16: BICM-ID and DD did not both run and recover a row")
    ok = res.crc_ok
    assert torch.equal(res.payload[ok], payload[ok])
    assert not bool((first_ok & ~ok).any()), "a first decode was lost"
    assert all(launches[k] > 0 for k in PATH_KERNELS[16]), launches
    print(f"CONFIG_16 at {esn0} dB: {int(ok.sum())}/{BATCH} decoded, "
          f"payloads equal; first decode failed on "
          f"{int((~first_ok).sum())} rows, BICM-ID re-decoded "
          f"{rec['bicm_rows']} rows and DD {rec['dd_rows']} (a receive, "
          f"summed over passes), recovering {recovered}; receive "
          f"{times[0] * 1e3:.2f} and {times[1] * 1e3:.2f} ms; iters mean "
          f"{res.iters.double().mean().item():.3f}; launches {launches} "
          f"over 2 receives")
    return {"launches": launches, "receive_ms": min(times) * 1e3,
            "esn0": esn0}


def drive_second_candidate(dev: torch.device) -> dict:
    """CONFIG_100 at batch 256 at -13 dB channel SNR (its waterfall),
    stepping down until some row's first-candidate decode fails (a chain
    with mfsk_sync_cands=1): with the defaults the runner-up decode must
    run (a second data-FIR launch), every row that decodes carries its
    payload, and no row the first candidate decoded is lost."""
    g = build_geometry(100)
    rx = RxChain(g, device=dev)
    first = RxChain(g, device=dev, mfsk_sync_cands=1)
    for snr in (-13.0, -13.5, -14.0, -14.5):
        buf, payload, delay = make_buffer(g, dev, snr, 130)
        first_ok = first.receive(buf).crc_ok
        if not bool(first_ok.all()):
            break
        print(f"CONFIG_100 at {snr} dB: every first decode passed, going "
              f"lower")
    assert not bool(first_ok.all()), "no first decode failed down to -14.5 dB"
    rx.reset_recovery()
    kernels.reset_launch_counts()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = rx.receive(buf)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: v // 2 for k, v in kernels.LAUNCHES.items()}
    ok = res.crc_ok
    recovered = int((ok & ~first_ok).sum())
    # each receive: the TS FIR, the data FIR, the runner-up's data FIR
    assert kernels.LAUNCHES["mix_fir_decimate"] == 6, kernels.LAUNCHES
    assert rx.recovery["mfsk_rows"] > 0
    assert torch.equal(res.payload[ok], payload[ok])
    assert not bool((first_ok & ~ok).any()), "a first decode was lost"
    at_frame = res.delay[ok].long() == delay
    print(f"CONFIG_100 at {snr} dB: {int(ok.sum())}/{BATCH} decoded, payloads "
          f"equal; first candidate failed on {int((~first_ok).sum())} rows, "
          f"the runner-up decode ran on them and recovered {recovered}; "
          f"{int(at_frame.sum())} decoded rows at the frame's delay; receive "
          f"{times[0] * 1e3:.2f} and {times[1] * 1e3:.2f} ms; launches a "
          f"receive {launches}")
    return {"launches": launches, "recovered": recovered,
            "receive_ms": min(times) * 1e3}


def drive_patterns(dev: torch.device) -> dict:
    """tests/test_patterns.py's bars at batch 256 on CONFIG_0 and
    CONFIG_100: ACK detected at -5 dB (metric over threshold, >= 8 symbols
    matched); CONFIG_100's ACK metric mean within 0.6-1.4x of the
    reference's 0.978 at -13 dB (and 4.671 at -5 dB); no false alarm on
    noise; BREAK not taken for an ACK at 0 dB (matched < 8)."""
    launches = dict.fromkeys(KERNELS, 0)
    gen = torch.Generator(device=dev).manual_seed(77)
    for cfg in (0, 100):
        sig = PatternSignaler(build_geometry(cfg), device=dev)
        g = sig.geom
        delay = 2 * g.nofdm * g.interp
        n = sig.passband_samples + 2 * delay

        def buffer(wave, snr):
            p_sig = float(np.mean(wave ** 2))
            sigma = np.sqrt(2.0 * p_sig * (g.fs / 2) / (
                10 ** (snr / 10.0) * g.bandwidth)) / np.sqrt(2.0)
            buf = sigma * torch.randn((BATCH, n), generator=gen, device=dev)
            buf[:, delay: delay + wave.size] += torch.as_tensor(
                wave, dtype=torch.float32, device=dev)
            return buf

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        metric, matched = sig.detect_ack(buffer(sig.ack_passband, -5.0))
        torch.cuda.synchronize()
        t_det = time.perf_counter() - t0
        assert (metric >= sig.threshold).all() and (matched >= 8).all(), (
            f"CONFIG_{cfg}: ACK missed at -5 dB")
        means = {}
        for snr, ref in ((-13.0, 0.978), (-5.0, 4.671)):
            means[snr] = float(sig.detect_ack(buffer(sig.ack_passband,
                                                     snr))[0].mean())
            if cfg == 100:
                assert 0.6 * ref <= means[snr] <= 1.4 * ref, (snr, means)
        noise_metric, _ = sig.detect_ack(
            0.1 * torch.randn((BATCH, n), generator=gen, device=dev))
        assert (noise_metric < sig.threshold).all(), "false alarm on noise"
        brk = buffer(sig.break_passband, 0.0)
        ack_m, ack_n = sig.detect_ack(brk)
        brk_m, brk_n = sig.detect_break(brk)
        assert (brk_m >= sig.threshold).all() and (brk_n >= 8).all()
        assert (ack_n < 8).all() and (ack_m < 0.5 * brk_m).all(), (
            f"CONFIG_{cfg}: BREAK taken for an ACK")
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["mix_fir_decimate"] == 6, kernels.LAUNCHES
        for k in KERNELS:
            launches[k] += kernels.LAUNCHES[k]
        print(f"patterns CONFIG_{cfg} (threshold {sig.threshold}), batch "
              f"{BATCH}: ACK at -5 dB detected on every row (first call "
              f"{t_det * 1e3:.2f} ms); ACK metric mean {means[-13.0]:.3f} at "
              f"-13 dB, {means[-5.0]:.3f} at -5 dB (reference 0.978, 4.671); "
              f"noise metric max {noise_metric.max().item():.3f}; BREAK at "
              f"0 dB: BREAK metric min {brk_m.min().item():.3f}, ACK matched "
              f"max {int(ack_n.max())}; launches {dict(kernels.LAUNCHES)}")
    return {"launches": launches}


def drive_fading(dev: torch.device) -> dict:
    """Watterson fading at batch 256: CONFIG_0 under the three presets at
    tests/test_multipath.py:31's Es/N0 with FER <= 0.125; CONFIG_9 under
    "moderate" at 12 dB channel SNR (tests/test_dd.py:119), where the DD
    chain of the link (dd_window (5, 9), 2 passes) must beat the plain one,
    FER(dd) <= 0.10 and FER(plain) >= 0.15. FER counts a row whose payload
    differs."""
    launches = dict.fromkeys(KERNELS, 0)

    def fer(rx, buf, payload):
        kernels.reset_launch_counts()
        res = rx.receive(buf)
        good = res.crc_ok & (res.payload == payload).all(-1)
        torch.cuda.synchronize()
        for k in KERNELS:
            launches[k] += kernels.LAUNCHES[k]
        return 1.0 - good.double().mean().item()

    g0 = build_geometry(0)
    rx0 = RxChain(g0, device=dev)
    for preset, esn0 in (("good", 8.0), ("moderate", 10.0), ("poor", 14.0)):
        buf, payload, _d = make_buffer(g0, dev, esn0, 42,
                                       fading=sim.WATTERSON_PRESETS[preset])
        f = fer(rx0, buf, payload)
        print(f"fading CONFIG_0 Watterson {preset} at {esn0} dB: FER {f:.4f} "
              f"(bar 0.125)")
        assert f <= 0.125, f"CONFIG_0 {preset}: FER {f}"
    g9 = build_geometry(9)
    tx = TxChain(g9, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1234)
    payload = torch.randint(0, 256, (BATCH, g9.frame_bytes), generator=gen,
                            device=dev, dtype=torch.uint8)
    frames = tx.transmit(payload)
    faded = torch.as_tensor(sim.watterson(frames, fs=g9.fs, seed=77,
                                          **sim.WATTERSON_PRESETS["moderate"]),
                            dtype=torch.float32, device=dev)
    delay = ((g9.preamble_nsymb + 2) * g9.nofdm + 50) * g9.interp
    buf = sim.awgn_passband(
        faded, sim.sigma_for_channel_snr(frames[0], 12.0, g9.fs,
                                         g9.bandwidth),
        delay, g9.nofdm * g9.buffer_nsymb * g9.interp, gen)
    f_plain = fer(RxChain(g9, device=dev), buf, payload)
    f_dd = fer(RxChain(g9, device=dev, dd=True, dd_window=(5, 9),
                       dd_passes=2), buf, payload)
    print(f"fading CONFIG_9 Watterson moderate at 12 dB channel SNR: FER "
          f"plain {f_plain:.4f}, DD (5, 9) x2 {f_dd:.4f} (bars: DD < plain, "
          f"DD <= 0.10, plain >= 0.15)")
    assert f_dd < f_plain and f_dd <= 0.10 and f_plain >= 0.15, (
        f_plain, f_dd)
    assert launches["mix_fir_decimate"] > 0, launches
    return {"launches": launches}


def path_launches(fn):
    """Run fn() with the launch counts set to 0 just before it; -> (its
    result, the counts read just after it)."""
    kernels.reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    return res, dict(kernels.LAUNCHES)


def drive_ber(dev: torch.device) -> dict:
    """BerHarness at batch 256, 1024 frames a point, 0.5 dB either side of
    the JAX harness's recorded waterfall (FER < 0.1 above it, > 0.1 below):
    CONFIG_9 baseband (1.5 dB, docs/ber_r4b.json), CONFIG_0 passband
    (parameter -4.7508 dB, FER 0.0957 there at 1024 frames, the record of
    the coherent acquisition in docs/ber_r5.json; docs/ber_r4b.json's
    -4.0008 predates it) and the control frames of CONFIG_100 (-12.5 dB,
    docs/ber_r5.json); then CONFIG_0's front_end_delta within 0.05 dB of
    the recorded -4.999 dB."""
    launches = dict.fromkeys(KERNELS, 0)
    out = {}
    for label, cfg, ctrl, mid, base in (
            ("CONFIG_9 baseband", 9, False, 1.5, True),
            ("CONFIG_0 passband", 0, False, -4.750776578036306, False),
            ("CONFIG_100 ctrl", 100, True, -12.5, False)):
        h = BerHarness(cfg, batch=BATCH, ctrl=ctrl, device=dev)
        run = h.run_point_baseband if base else h.run_point
        fer = {}
        for esn0 in (mid + 0.5, mid - 0.5):
            t0 = time.perf_counter()
            p, n = path_launches(lambda: run(esn0, 4 * BATCH))
            dt = time.perf_counter() - t0
            for k in KERNELS:
                launches[k] += n[k]
            fer[esn0] = p.fer
            print(f"BER {label} at {esn0:+.4f} dB: FER {p.fer:.4f} BER "
                  f"{p.ber:.6f} over {p.frames} frames in {dt:.2f} s; "
                  f"launches {n}")
            assert p.frames == 4 * BATCH
        assert fer[mid + 0.5] < 0.1 < fer[mid - 0.5], (label, fer)
        if not base:
            assert launches["mix_fir_decimate"] > 0
        out[label] = fer
    h0 = BerHarness(0, batch=BATCH, device=dev)
    delta, n = path_launches(h0.front_end_delta)
    for k in KERNELS:
        launches[k] += n[k]
    print(f"front_end_delta CONFIG_0: {delta:.4f} dB (recorded -4.999, "
          f"limit 0.05 dB)")
    assert abs(delta - (-4.999)) <= 0.05, delta
    return {"launches": launches, "fer": out, "delta": delta}


def timed_runs(fn, reps: int = 3) -> tuple:
    """fn() reps times, each ending in a synchronize -> (last result,
    host ms of each)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return res, times


def drive_chain_surface(dev: torch.device) -> dict:
    """CONFIG_9 at batch 256: decode_at on frames at +20 Hz (the offset as
    applied) at the known delay, and refine_decode on sibling rows cut as
    link/node.py:483-496 cuts them (transmit_batch frames back to back,
    row k drifted 37 * (k % 7) samples, the next frame after it, +20 Hz,
    margin 256): every row decodes its payload, refine_decode's delays are
    the drifts. cfo_range="narrow" on CONFIG_9 and 0 at +30 / -30 Hz
    (half the rows each) at NARROW_DB: every row decodes. measure_signal_dbm on white noise of sigma 0.1 within 0.1 dB
    of 10*log10(2 sigma^2 sum(h^2) / 1 mW)."""
    launches = dict.fromkeys(KERNELS, 0)

    def count(n):
        for k in KERNELS:
            launches[k] += n[k]

    g = build_geometry(9)
    tx, rx = TxChain(g, device=dev), RxChain(g, device=dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    payload = torch.randint(0, 256, (BATCH, g.frame_bytes), generator=gen,
                            device=dev, dtype=torch.uint8)
    frames = tx.transmit(payload)
    f_len = frames.shape[1]
    f_app = round(20.0 * f_len / g.fs) * g.fs / f_len
    delay = ((g.preamble_nsymb + 2) * g.nofdm + 50) * g.interp
    buf = sim.awgn_passband(sim.apply_cfo(frames, g.fs, g.fc, 20.0),
                            sim.sigma_for_esn0(12.0), delay,
                            g.nofdm * g.buffer_nsymb * g.interp, gen)
    freq = torch.full((BATCH,), f_app, device=dev)
    (at, t_at), n = path_launches(lambda: timed_runs(
        lambda: rx.decode_at(buf, torch.full((BATCH,), delay - 8,
                                             device=dev), freq)))
    count(n)
    assert bool(at[1].all()) and torch.equal(at[0], payload), "decode_at"
    assert n["mix_fir_decimate"] == 3, n
    print(f"decode_at CONFIG_9 at +{f_app:.3f} Hz, batch {BATCH}: every row "
          f"decoded, payloads equal; {['%.2f' % t for t in t_at]} ms; "
          f"launches {n} over 3 calls")
    # sibling rows as the link cuts them: row k holds frame k of a
    # transmit_batch, drifted 37 * (k % 7) samples past its nominal slot
    # at `margin`, and frame k + 1 after a 37-sample gap
    batch_frames = tx.transmit_batch(payload)
    drift, margin = 37, 256
    buf_len = g.nofdm * g.buffer_nsymb * g.interp
    shift = drift * (torch.arange(BATCH, device=dev) % 7)
    rows = torch.zeros((BATCH, buf_len), device=dev)
    for k in range(BATCH):
        at_k = margin + int(shift[k])
        rows[k, at_k: at_k + f_len] = batch_frames[k]
        nxt = at_k + f_len + drift
        rows[k, nxt: nxt + f_len] = batch_frames[(k + 1) % BATCH]
    rows = sim.apply_cfo(rows, g.fs, g.fc, 20.0)
    rows = rows + 0.02 * torch.randn(rows.shape, generator=gen, device=dev)
    f_air = round(20.0 * buf_len / g.fs) * g.fs / buf_len
    (ref, t_ref), n = path_launches(lambda: timed_runs(
        lambda: rx.refine_decode(rows, torch.full((BATCH,), margin,
                                                  device=dev),
                                 torch.full((BATCH,), f_air, device=dev),
                                 margin)))
    count(n)
    want_delay = margin + shift
    assert bool(ref[1].all()) and torch.equal(ref[0], payload), "refine"
    assert torch.equal(ref[5].long(), want_delay), "refine_decode delays"
    assert n["deep_mf_score"] == 3 and n["mix_fir_decimate"] == 3, n
    print(f"refine_decode CONFIG_9 at +{f_air:.3f} Hz, {BATCH} sibling rows "
          f"drifted 0-222 samples, window {margin}: every row decoded, "
          f"delays equal the drifts; {['%.2f' % t for t in t_ref]} ms; "
          f"launches {n} over 3 calls")
    out = {"decode_at_ms": min(t_at), "refine_decode_ms": min(t_ref)}
    for cfg in (9, 0):
        gc = build_geometry(cfg)
        txc = TxChain(gc, device=dev)
        pay = torch.randint(0, 256, (BATCH, gc.frame_bytes), generator=gen,
                            device=dev, dtype=torch.uint8)
        fr = txc.transmit(pay)
        half = BATCH // 2
        fr = torch.cat([sim.apply_cfo(fr[:half], gc.fs, gc.fc, 30.0),
                        sim.apply_cfo(fr[half:], gc.fs, gc.fc, -30.0)])
        d = ((gc.preamble_nsymb + 2) * gc.nofdm + 50) * gc.interp
        bufc = sim.awgn_passband(fr, sim.sigma_for_esn0(NARROW_DB), d,
                                 gc.nofdm * gc.buffer_nsymb * gc.interp, gen)
        rxn = RxChain(gc, device=dev, cfo_range="narrow")
        (res, t_n), n = path_launches(lambda: timed_runs(
            lambda: rxn.receive(bufc)))
        count(n)
        assert bool(res.crc_ok.all()) and torch.equal(res.payload, pay), (
            f"narrow CONFIG_{cfg}: {int(res.crc_ok.sum())}/{BATCH}")
        assert all(n[k] > 0 for k in PATH_KERNELS[cfg]), n
        fo = res.freq_offset
        print(f"cfo_range narrow CONFIG_{cfg} at +30/-30 Hz, {NARROW_DB} dB, "
              f"batch {BATCH}: "
              f"every row decoded, payloads equal; freq_offset "
              f"{fo[:half].mean().item():+.3f} / {fo[half:].mean().item():+.3f}"
              f" Hz; receive {['%.2f' % t for t in t_n]} ms; launches {n}")
        out[f"narrow_{cfg}_ms"] = min(t_n)
    sigma = 0.1
    noise = sigma * torch.randn((BATCH, buf_len), generator=gen, device=dev)
    (dbm, t_m), n = path_launches(lambda: timed_runs(
        lambda: rx.measure_signal_dbm(noise)))
    count(n)
    h2 = float((rx._fir_ts.double() ** 2).sum())
    want = 10 * np.log10(2 * sigma ** 2 * h2 / 1e-3)
    # a row's estimate spreads ~0.07 dB (the TS FIR passes ~1/20 of the
    # band: ~4000 independent samples a row); the batch mean ~0.005 dB
    mean_db = 10 * np.log10(torch.mean(10 ** (dbm.double() / 10)).item())
    assert abs(mean_db - want) <= 0.1, (mean_db, want)
    assert (dbm - want).abs().max().item() <= 0.5, (dbm, want)
    assert n["mix_fir_decimate"] == 3, n
    print(f"measure_signal_dbm [{BATCH},{buf_len}] noise sigma {sigma}: "
          f"mean {mean_db:.4f} dBm (rows {dbm.min().item():.4f} .. "
          f"{dbm.max().item():.4f}), analytic {want:.4f} (limits 0.1 / 0.5 "
          f"dB); {['%.2f' % t for t in t_m]} ms")
    out["launches"] = launches
    return out


def drive_stream_and_obs(dev: torch.device) -> dict:
    """StreamReceiver (batch-1 receives on the card) on
    tests/test_stream.py:12-37's stream: three CONFIG_9 frames with 30000-
    sample gaps in 10 ms chunks, then 200 chunks of silence: 3/3 decoded in
    order. Then rx_diagnostics on tests/test_obs_gbf.py:55-74's buffer:
    crc_ok, the constellation and channel-magnitude shapes, sync metric
    peak above 0.7, a 257-bin waterfall."""
    g = build_geometry(9)
    tx = TxChain(g, device=dev)
    payloads = torch.stack([torch.full((g.frame_bytes,), 10 * i,
                                       dtype=torch.uint8)
                            for i in range(1, 4)]).to(dev)
    frames = tx.transmit(payloads).cpu().numpy()
    gap = np.zeros(30000, np.float32)
    rng = np.random.default_rng(0)
    stream = np.concatenate(
        [gap] + sum([[f.astype(np.float32), gap] for f in frames], []))
    stream = stream + 0.002 * rng.standard_normal(len(stream)).astype(
        np.float32)
    rx = RxChain(g, device=dev)
    receives = []
    receive = rx.receive

    def counted(buf):
        t0 = time.perf_counter()
        res = receive(buf)
        torch.cuda.synchronize()
        receives.append(((time.perf_counter() - t0) * 1e3,
                         bool(res.crc_ok[0]), int(res.iters[0])))
        return res

    rx.receive = counted
    sr = StreamReceiver(g, rx=rx)

    def run():
        got = []
        for pos in range(0, len(stream), 480):
            got += sr.feed(stream[pos: pos + 480])
        for _ in range(200):
            got += sr.feed(np.zeros(480, np.float32))
        return got

    t0 = time.perf_counter()
    got, n = path_launches(run)
    dt = time.perf_counter() - t0
    assert len(got) == 3, f"stream: {len(got)} of 3 frames"
    for i, res in enumerate(got):
        assert torch.equal(res.payload[0], payloads[i]), f"stream frame {i}"
    assert n["mix_fir_decimate"] > 0, n
    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else float("nan")

    steady = [r[0] for r in receives[1:]]
    hit = [r for r in receives[1:] if r[1]]
    miss = [r for r in receives[1:] if not r[1]]
    print(f"StreamReceiver CONFIG_9: 3/3 frames in order over "
          f"{len(stream) + 96000} samples in {dt:.2f} s, {len(receives)} "
          f"batch-1 receives, median {median(steady):.2f} ms (first "
          f"{receives[0][0]:.2f}): {len(hit)} that decoded a frame, median "
          f"{median([r[0] for r in hit]):.2f} ms, LDPC sweeps "
          f"{[r[2] for r in hit]}; {len(miss)} that did not, median "
          f"{median([r[0] for r in miss]):.2f} ms, sweeps "
          f"{sorted(set(r[2] for r in miss))}; launches {n}")
    # one receive of a window without a frame under the profiler: device
    # busy (the table's "Self CUDA time total") against its host time
    quiet = torch.as_tensor(
        0.002 * rng.standard_normal((1, sr.buf_len)).astype(np.float32))
    receive(quiet)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        receive(quiet)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=3)
    m = re.search(r"Self CUDA time total: ([\d.]+)(s|ms|us)", table)
    assert m, f"the profiler saw no device time:\n{table}"
    busy = float(m.group(1)) * {"s": 1e3, "ms": 1.0, "us": 1e-3}[m.group(2)]
    t_plain = min(timed_runs(lambda: receive(quiet))[1])
    print(f"StreamReceiver CONFIG_9, a window without a frame: receive "
          f"{t_plain:.2f} ms (min of 3), under the profiler {wall:.2f} ms; "
          f"device busy {busy:.3f} ms, idle share "
          f"{1 - busy / t_plain:.3f} of the unprofiled receive")
    launches = dict(n)
    frame = tx.transmit(torch.arange(g.frame_bytes, dtype=torch.uint8,
                                     device=dev)[None])
    buf = sim.awgn_passband(frame, sim.sigma_for_esn0(14), 7000,
                            g.nofdm * g.buffer_nsymb * g.interp,
                            torch.Generator(device=dev).manual_seed(0))
    d, n = path_launches(lambda: obs.rx_diagnostics(RxChain(g, device=dev),
                                                    buf[0].cpu().numpy()))
    assert d["crc_ok"]
    assert d["constellation"].shape == (g.n_data,)
    assert d["channel_mag"].shape == (g.nsymb, g.nc)
    assert d["sync_metric"].max() > 0.7
    assert d["waterfall"].shape[1] == 257
    for k in KERNELS:
        launches[k] += n[k]
    print(f"rx_diagnostics CONFIG_9 at 14 dB: crc ok, delay {d['delay']}, "
          f"snr {d['snr_db']:.3f} dB, sync metric peak "
          f"{d['sync_metric'].max():.4f}, constellation {d['constellation'].shape}"
          f", channel_mag {d['channel_mag'].shape}; launches {n}")
    return {"launches": launches,
            "stream_receive_ms": steady[len(steady) // 2]}


def drive_link(dev: torch.device, label: str, cfg: ArqConfig, snr_db: float,
               n_bytes: int, kernels_used: tuple) -> dict:
    """A two-node LinkSimulator session (link/sim.py's channel, host numpy;
    both nodes' chains on the card) from cfg.init_configuration: n_bytes of
    random payload must arrive intact. Each node's receives (RxChain.receive
    calls, refine_decode calls) are counted while it handles a delivered
    block; every kernel of kernels_used must launch."""
    nodes = {"commander": ArqNode("VE3XYZ", P.COMMANDER, cfg, device=dev),
             "responder": ArqNode("N0CALL", P.RESPONDER, cfg, device=dev)}
    per = {k: {"blocks": 0, "receives": 0, "refines": 0, "sweeps": 0,
               "ms": []} for k in nodes}
    current = [None]
    for key, nd in nodes.items():
        def on_samples(samples, now, inner=nd.on_samples, key=key):
            current[0] = key
            t0 = time.perf_counter()
            inner(samples, now)
            per[key]["ms"].append((time.perf_counter() - t0) * 1e3)
            per[key]["blocks"] += 1
            current[0] = None
        nd.on_samples = on_samples
    receive, refine = RxChain.receive, RxChain.refine_decode

    def counted_receive(self, pb):
        res = receive(self, pb)
        if current[0] is not None:
            per[current[0]]["receives"] += 1
            per[current[0]]["sweeps"] += int(res.iters.sum())
        return res

    def counted_refine(self, *args):
        out = refine(self, *args)
        if current[0] is not None:
            per[current[0]]["refines"] += 1
            per[current[0]]["sweeps"] += int(out[2].sum())
        return out

    RxChain.receive, RxChain.refine_decode = counted_receive, counted_refine
    try:
        cmd, rsp = nodes["commander"], nodes["responder"]
        link = LinkSimulator(cmd, rsp, ChannelModel(snr_db=snr_db, seed=0))
        payload = bytes(np.random.default_rng(0).integers(0, 256, n_bytes)
                        .astype(np.uint8))
        cmd.send_data(payload)
        cmd.connect("N0CALL")
        t0 = time.perf_counter()
        sim_s, n = path_launches(lambda: link.run(
            max_sim_s=3600, until=lambda: len(rsp.fifo_rx) >= n_bytes))
        wall = time.perf_counter() - t0
    finally:
        RxChain.receive, RxChain.refine_decode = receive, refine
    got = rsp.received()
    assert got == payload, f"{label}: {len(got)}/{n_bytes} bytes, or wrong"
    assert all(n[k] > 0 for k in kernels_used), f"{label}: launches {n}"
    text = "; ".join(
        f"{k}: {v['blocks']} blocks, {v['receives']} receives + "
        f"{v['refines']} refine_decode calls, {v['sweeps']} LDPC sweeps, "
        f"block handling median {sorted(v['ms'])[len(v['ms']) // 2]:.2f} ms"
        f" max {max(v['ms']):.2f} ms" for k, v in per.items())
    print(f"link {label}: {n_bytes}/{n_bytes} bytes intact, simulated "
          f"{sim_s:.3f} s, wall {wall:.2f} s, final config commander "
          f"{cmd.current_configuration} responder "
          f"{rsp.current_configuration}, gearshift ups "
          f"{cmd.stats.gearshift_ups} downs {cmd.stats.gearshift_downs}, "
          f"blocks sent {cmd.stats.blocks_sent}; {text}; launches {n}")
    return {"launches": n, "wall_s": wall, "sim_s": sim_s}


def _ctl_lines(sock, timeout: float) -> list:
    sock.settimeout(timeout)
    buf = b""
    try:
        while b"\r" not in buf:
            chunk = sock.recv(4096)
            if not chunk:
                break
            buf += chunk
    except OSError:
        pass
    return [ln.decode() for ln in buf.split(b"\r") if ln]


def drive_tcp(dev: torch.device, n_bytes: int = 2048) -> dict:
    """Two ArqTcpServers in this process (each node driven by its own
    thread, the two sharing the cached chains on the card) joined by the
    in-process pair transport, driven through localhost sockets as a VARA
    client drives them: MYCALL, LISTEN ON, CONNECT, n_bytes through the
    data ports, DISCONNECT. Every byte must arrive; the servers' threads
    are stopped and joined."""
    import socket

    pair = PairTransport()
    cfg = ArqConfig(init_configuration=0, gear_shift_on=True, batch_size=5)
    srv = [ArqTcpServer(base_port=port, config=cfg, transport=end,
                        device=dev)
           for port, end in ((17802, pair.a), (17812, pair.b))]
    socks = []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        for s in srv:
            s.start()
        time.sleep(0.5)
        ctl_a, dat_a, ctl_b, dat_b = socks = [
            socket.create_connection(("127.0.0.1", port))
            for port in (17802, 17803, 17812, 17813)]
        ctl_b.sendall(b"MYCALL N0CALL\r")
        assert "OK" in _ctl_lines(ctl_b, 5.0)
        ctl_b.sendall(b"LISTEN ON\r")
        assert "OK" in _ctl_lines(ctl_b, 5.0)
        ctl_a.sendall(b"CONNECT VE3XYZ N0CALL\r")
        seen = {"a": [], "b": []}
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline and not all(
                any(ln.startswith("CONNECTED") for ln in v)
                for v in seen.values()):
            seen["a"] += _ctl_lines(ctl_a, 0.5)
            seen["b"] += _ctl_lines(ctl_b, 0.5)
        assert all(any(ln.startswith("CONNECTED") for ln in v)
                   for v in seen.values()), f"tcp: no CONNECTED: {seen}"
        t_conn = time.perf_counter() - t0
        payload = bytes(np.random.default_rng(1).integers(0, 256, n_bytes)
                        .astype(np.uint8))
        t1 = time.perf_counter()
        dat_a.sendall(payload)
        got = b""
        dat_b.settimeout(0.5)
        while time.perf_counter() - t1 < 90 and len(got) < n_bytes:
            try:
                got += dat_b.recv(8192)
            except OSError:
                pass
        t_data = time.perf_counter() - t1
        assert got == payload, f"tcp: {len(got)}/{n_bytes} bytes, or wrong"
        ctl_a.sendall(b"DISCONNECT\r")
        lines = []
        deadline = time.perf_counter() + 30
        while (time.perf_counter() < deadline
               and "DISCONNECTED" not in lines):
            lines += _ctl_lines(ctl_a, 0.5)
        assert "DISCONNECTED" in lines, f"tcp: {lines}"
        final_cfg = srv[0].node.current_configuration
    finally:
        for sock in socks:
            sock.close()
        for s in srv:
            s.stop()
        for s in srv:
            for t in s._threads:
                t.join(5.0)
    torch.cuda.synchronize()
    n = dict(kernels.LAUNCHES)
    assert not any(t.is_alive() for s in srv for t in s._threads)
    assert n["mix_fir_decimate"] > 0 and n["deep_mf_max"] > 0, n
    print(f"tcp: two ArqTcpServers on localhost: CONNECTED in {t_conn:.2f} "
          f"s, {n_bytes}/{n_bytes} bytes through the data ports in "
          f"{t_data:.2f} s (final config {final_cfg}), DISCONNECTED, every "
          f"server thread joined; launches {n}")
    return {"launches": n}


def pool_capture(g, dev: torch.device, n_ch: int, n_syms: int,
                 esn0: float, seed: int):
    """n_ch channels of n_syms symbols of capture at Es/N0 esn0: channel
    c's frame (a random payload) at a lead of (1 + c % 4) symbols plus
    (97 c mod symbol) samples, so that every frame lies whole in the first
    34 symbols, white noise everywhere -> (payloads [C, frame_bytes],
    streams [C, n_syms * symbol]) as host numpy: the pools' input."""
    sym = g.nofdm * g.interp
    gen = torch.Generator(device=dev).manual_seed(seed)
    payload = torch.randint(0, 256, (n_ch, g.frame_bytes), generator=gen,
                            device=dev, dtype=torch.uint8)
    frames = TxChain(g, device=dev).transmit(payload)
    streams = sim.sigma_for_esn0(esn0) * torch.randn(
        (n_ch, n_syms * sym), generator=gen, device=dev)
    for c in range(n_ch):
        lead = (1 + c % 4) * sym + (97 * c) % sym
        streams[c, lead: lead + frames.shape[1]] += frames[c]
    return payload.cpu().numpy(), streams.cpu().numpy()


def drive_pools(dev: torch.device, n_ch: int = BATCH, k_syms: int = 17,
                esn0: float = 12.0) -> dict:
    """FusedDevicePool, DeviceStreamPool and StreamPool over n_ch channels
    of CONFIG_9 capture (pool_capture), fed in blocks of k_syms symbols
    (85 = the window: 5 rounds until the windows first fill and every
    countdown is due). Every channel must decode its own payload. Each
    round or step ends in its host read; printed per pool: ms per round,
    LDPC sweeps per row (fused: from the packed iters), rounds, frames
    decoded, H2D and D2H bytes per round, and Msamples/s of ingest (the
    samples fed over the rounds' wall time). The idle share of a clean
    fused round (3): its device busy over its wall, the wall timed without
    the profiler, the busy from the same round again under the profiler
    on a second pool fed the same blocks (its packed payload, ok and delay
    bytes equal to the first's). The unfused pools read their rows with
    convert.host_rows (float64 columns: 8 bytes a field byte or
    scalar)."""
    g = build_geometry(9)
    sym = g.nofdm * g.interp
    n_rounds = g.buffer_nsymb // k_syms
    rx = RxChain(g, device=dev)
    payloads, streams = pool_capture(g, dev, n_ch, n_rounds * k_syms, esn0,
                                     909)
    blk = k_syms * sym
    blocks = [np.ascontiguousarray(streams[:, r * blk: (r + 1) * blk])
              for r in range(n_rounds)]
    want = {c: bytes(payloads[c]) for c in range(n_ch)}
    launches = dict.fromkeys(KERNELS, 0)
    out = {}

    def report(name, got, ms, dispatches, h2d, d2h, extra=""):
        n_good = sum(got.get(c) == w for c, w in want.items())
        assert n_good == n_ch, f"{name}: {n_good}/{n_ch} channels decoded"
        fed = n_ch * blk * len(ms)
        total = sum(ms) / 1e3
        print(f"{name}, {n_ch} channels of CONFIG_9 at {esn0} dB, "
              f"{k_syms}-symbol blocks: {n_ch}/{n_ch} channels decoded "
              f"their payloads in {len(ms)} rounds, {dispatches} batched "
              f"receives; ms per round {[round(t, 2) for t in ms]}; H2D "
              f"{h2d / 1e6:.3f} MB and D2H {d2h / 1e3:.3f} kB per "
              f"round (mean); ingest {fed / total / 1e6:.3f} Msamples/s"
              f"{extra}")
        out[name] = {"ms": ms, "msamples_per_s": fed / total / 1e6}

    def counted(fn):
        kernels.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        for k in KERNELS:
            launches[k] += kernels.LAUNCHES[k]
        return res

    # FusedDevicePool: every row decoded every round, one packed D2H
    pool = serve.FusedDevicePool(g, n_ch, rx=rx)
    got, ms, sweeps = {}, [], []
    d2h = n_ch * (g.frame_bytes + 21)

    def one_round(p, r):
        nxt = blocks[r + 1] if r + 1 < n_rounds else None
        packed = p.round(blocks[r], nxt)
        return p.unpack(packed), packed
    for r in range(n_rounds):
        t0 = time.perf_counter()
        res, packed = counted(lambda: one_round(pool, r))
        ms.append((time.perf_counter() - t0) * 1e3)
        if r == 3:                      # a clean round, not yet due
            packed3 = packed.clone()
        cols = serve._columns(packed.cpu().numpy(), g.frame_bytes)
        sweeps.append(float(cols[5].mean()))
        for c, rr in res:
            got.setdefault(c, bytes(rr.payload[0]))
    # round 3 again, on a second pool fed the same blocks, under the profiler
    again = serve.FusedDevicePool(g, n_ch, rx=rx)
    for r in range(3):
        one_round(again, r)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, packed = one_round(again, 3)
        torch.cuda.synchronize()
    fb5 = g.frame_bytes + 5
    assert torch.equal(packed[:, :fb5], packed3[:, :fb5]), (
        "round 3's payload, ok or delay differs on the second pool")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=3)
    m = re.search(r"Self CUDA time total: ([\d.]+)(s|ms|us)", table)
    assert m, f"the profiler saw no device time:\n{table}"
    busy = float(m.group(1)) * {"s": 1e3, "ms": 1.0, "us": 1e-3}[m.group(2)]
    del again
    report("FusedDevicePool", got, ms, pool.batched_dispatches,
           n_ch * blk * 4, d2h,
           f"; LDPC sweeps per row, mean per round "
           f"{[round(x, 3) for x in sweeps]}; round 3: device busy "
           f"{busy:.3f} ms (the same round under the profiler on a second "
           f"pool, its payload, ok and delay bytes equal) of its "
           f"{ms[3]:.2f} ms, idle share {1 - busy / ms[3]:.3f}")
    del pool

    # DeviceStreamPool: windows on the card, ready rows gathered there
    pool = serve.DeviceStreamPool(g, n_ch, rx=rx)
    got, ms = {}, []
    for block in blocks:
        t0 = time.perf_counter()
        res = counted(lambda: (pool.feed_block(block), pool.step())[1])
        ms.append((time.perf_counter() - t0) * 1e3)
        for c, rr in res:
            got.setdefault(c, bytes(rr.payload[0]))
    report("DeviceStreamPool", got, ms, pool.batched_dispatches,
           n_ch * blk * 4 + 8 * pool.rows_dispatched / n_rounds,
           pool.rows_dispatched * 8 * (g.frame_bytes + 7) / n_rounds)
    del pool

    # StreamPool: windows in host memory (runtime WindowPool), ready rows
    # gathered on the host and sent in one pinned copy
    pool = serve.StreamPool(g, n_ch, rx=rx)
    got, ms = {}, []
    for block in blocks:
        t0 = time.perf_counter()
        res = counted(lambda: (pool.feed_block(block), pool.step())[1])
        ms.append((time.perf_counter() - t0) * 1e3)
        for c, rr in res:
            got.setdefault(c, bytes(rr.payload[0]))
    report("StreamPool", got, ms, pool.batched_dispatches,
           4 * pool.buf_len * pool.rows_dispatched / n_rounds,
           pool.rows_dispatched * 8 * (g.frame_bytes + 7) / n_rounds)
    assert all(launches[k] > 0 for k in PATH_KERNELS[9]), launches
    print(f"pools: launches {launches}")
    return {"launches": launches, **out}


def decode_golden(cfg: int, dev: torch.device, density: int = HIGH_DENSITY,
                  estimator: str = "auto") -> None:
    rx = RxChain(build_geometry(cfg, density, estimator=estimator),
                 device=dev)
    tag = f"cfg{cfg}ld" if density == LOW_DENSITY else f"cfg{cfg}"
    res = rx.receive(torch.as_tensor(golden(f"{tag}_rx_buffer")[None]))
    want = torch.as_tensor(golden(f"{tag}_rx_bytes").astype(np.uint8))
    assert bool(res.crc_ok[0]), f"{tag}_rx_buffer: CRC failed"
    assert torch.equal(res.payload[0].cpu(), want), f"{tag}: bytes differ"
    print(f"golden {tag}_rx_buffer ({estimator} estimator): decoded to the "
          f"reference bytes (snr {res.snr_db[0].item():.2f} dB)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    native.load_library()
    print(f"kernel library {native.library_path().name}: ready in "
          f"{time.perf_counter() - t0:.2f} s (build at first use)")

    dev = torch.device("cuda")
    log = ShapeLog()
    # every main path's chain: CONFIG_0 shares CONFIG_3's buffer and frame
    # sizes, CONFIG_102 CONFIG_101's, the others each have their own; the
    # control frames of CONFIG_100 and 101 their data FIR's
    chains = {f"CONFIG_{cfg}": RxChain(build_geometry(cfg), device=dev)
              for cfg in (3, 9, 16, 13, 11, 100, 101)}
    for cfg in (100, 101):
        chains[f"CONFIG_{cfg} ctrl"] = RxChain(build_geometry(cfg),
                                               device=dev, ctrl=True)
    rx3 = chains["CONFIG_3"]
    rx0 = RxChain(build_geometry(0), device=dev)
    refine_only = {k: chains[k] for k in ("CONFIG_11", "CONFIG_13",
                                          "CONFIG_16")}
    gen = torch.Generator(device=dev).manual_seed(1234)
    stats = {"mix_fir_decimate": check_mix_fir_decimate(
                 chains, gen, PatternSignaler(build_geometry(0), device=dev),
                 {"CONFIG_0": rx0, "CONFIG_9": chains["CONFIG_9"]}),
             "deep_mf_score": check_deep_mf_score(rx3, gen, refine_only,
                                                  chains["CONFIG_9"]),
             "deep_mf_max": check_deep_mf_max(rx0, gen),
             "pilot_cand_score": check_pilot_cand_score(rx0, gen)}
    # a link node's batch-1 receive at CONFIG_0
    check_deep_mf_max(rx0, gen, batch=1)
    check_pilot_cand_score(rx0, gen, batch=1)
    del rx0, rx3, refine_only, chains
    torch.cuda.empty_cache()

    # each path from counts of 0, read just after it; the kernels line
    # reports each kernel's launches summed over the paths
    runs = []

    def run(label, fn, *args, **kw):
        log.path = label
        runs.append(fn(*args, **kw)["launches"])

    for cfg in (3, 9, 0, 16, 13, 11, 100, 101, 102):
        run(f"CONFIG_{cfg}", drive_main_path, cfg, dev)
    for cfg in (100, 101):
        run(f"CONFIG_{cfg} ctrl", drive_main_path, cfg, dev, ctrl=True)
    run("rescue", drive_rescue, dev)
    run("near threshold", drive_near_threshold, dev)
    run("second candidate", drive_second_candidate, dev)
    run("patterns", drive_patterns, dev)
    run("fading", drive_fading, dev)
    run("BER", drive_ber, dev)
    run("chain surface", drive_chain_surface, dev)
    run("stream and obs", drive_stream_and_obs, dev)
    # the link, the TCP service and the serving pools
    t_new = time.perf_counter()
    run("link CONFIG_0", drive_link,
        dev, "CONFIG_0 up, gearshift on, 20 dB",
        ArqConfig(init_configuration=0, gear_shift_on=True,
                  robust_enabled=False, batch_size=3), 20.0, 4096,
        ("mix_fir_decimate", "deep_mf_score", "deep_mf_max",
         "pilot_cand_score"))
    run("link ROBUST", drive_link,
        dev, "ROBUST from CONFIG_100, -5 dB channel SNR",
        ArqConfig(init_configuration=100, gear_shift_on=True,
                  robust_enabled=True, batch_size=5), -5.0, 200,
        ("mix_fir_decimate",))
    run("tcp", drive_tcp, dev)
    run("pools", drive_pools, dev)
    print(f"link, tcp and pool phases: {time.perf_counter() - t_new:.1f} s")
    launches = {k: sum(r[k] for r in runs) for k in KERNELS}
    log.path = "golden"
    for cfg in (0, 3, 9):
        decode_golden(cfg, dev)
    for cfg in (*range(10, 17), 100, 101, 102):
        for density in (HIGH_DENSITY, LOW_DENSITY):
            decode_golden(cfg, dev, density)
    for cfg in (15, 16):                # zero-forcing, as the reference
        decode_golden(cfg, dev, estimator="reference")
    # every shape the paths launched that phase 1 did not hold
    t0 = time.perf_counter()
    held = hold_path_shapes(log)
    print(f"path shapes: {len(held)} not held in phase 1, each held now on "
          f"its path's operands, in {time.perf_counter() - t0:.1f} s; "
          f"launches on the paths of the {len(log.held)} shapes held in "
          f"phase 1: " + "; ".join(
              f"{name} {list(key)}: {log.launches.get((name, key), 0)}"
              for name, key in sorted(log.held, key=str)))
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name],
         **{k: stats[name][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "kernel_ms")}}
        for name, (src, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
