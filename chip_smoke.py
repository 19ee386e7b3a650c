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
     frames of 100 and 101) and in the ACK/BREAK detector's form, and
     deep_mf_score also at the refine shapes of CONFIG_11 (three preamble
     symbols), 13 (two) and 16 (one);
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
     (tests/test_dd.py:119's bars);
  3. decodes the reference's CONFIG_0, 3 and 9 capture buffers, those of
     CONFIG_10-16 and 100-102 at both pilot densities, and CONFIG_15/16's
     with the zero-forcing estimator (tests/golden), to their reference
     bytes.
Any failure raises (non-zero exit). Without a CUDA device it exits non-zero
before printing a result. The line before the last lists the kernels
(launches on the main paths, error, times, bound, library time); the last
line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.core.modes import HIGH_DENSITY, LOW_DENSITY
from mercury_tpu_torch import native
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.dsp import kernels
from mercury_tpu_torch.modem.patterns import PatternSignaler
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain

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
    return (f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
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
              ntaps: int) -> dict:
    """Bytes: the passband windows (4 B), the oscillator over their union
    (8 B), taps, output (8 B); flops: 2 per sample mixed, 4 per tap of an
    output (FP32)."""
    pb_n, osc_n = fir_window_samples(n, start, n_out, stride, offset, ntaps)
    return bound(4 * pb_n + 8 * osc_n + 4 * ntaps + 8 * b * n_out,
                 2 * pb_n + 4 * b * n_out * ntaps, "FP32")


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
                           pattern: PatternSignaler) -> dict:
    """For each main path's chain (label -> chain; CONFIG_3 first, whose
    numbers go into the kernels line): the TS form over the whole buffer,
    stride 4, and the per-row-start data-FIR form of that mode's frame
    (a control-frame chain: its frame only, its buffer is its data
    chain's), against the plain version: max abs error <= 1e-4. Then the
    pattern detector's "same" form (stride 4, the data taps) over an
    ACK/BREAK buffer of `pattern`'s geometry. Each timed through the
    wrapper and as the kernel alone, beside its bound; the "same" forms also
    beside the conv1d yardstick (which must agree within 1e-4)."""
    lib = native.load_library()
    out = {"max_abs_err": 0.0, "paths": {}}

    def same_form(label, pb, osc, taps, g):
        """The strided "same" form (every row from 0) of pb [BATCH, n]."""
        n = pb.shape[1]
        ntaps = taps.shape[0]
        args = (pb, osc, taps, g.interp)
        err = (kernels.mix_fir_decimate(*args)
               - kernels.mix_fir_decimate_ref(*args)).abs().max().item()
        library = fir_library(*args, g)
        lib_err = (library() - kernels.mix_fir_decimate(*args)).abs().max(
            ).item()
        assert err <= 1e-4, f"{label}: max abs err {err}"
        assert lib_err <= 1e-4, f"{label}: conv1d yardstick differs by {lib_err}"
        n_out = (n - 1) // g.interp + 1
        dst = torch.empty((BATCH, n_out), dtype=torch.complex64,
                          device=pb.device)
        st = {"max_abs_err": err, "n_ts": n_out,
              "ms": cuda_ms(lambda: kernels.mix_fir_decimate(*args)),
              "kernel_ms": raw_ms(lambda: lib.mfd_launch(
                  pb.data_ptr(), osc.data_ptr(), taps.data_ptr(), None,
                  dst.data_ptr(), BATCH, n, n_out, g.interp,
                  (ntaps - 1) // 2, ntaps, kernels._stream(pb))),
              "plain_ms": cuda_ms(lambda: kernels.mix_fir_decimate_ref(*args)),
              "library_ms": cuda_ms(library)}
        st.update(fir_bound(BATCH, n, torch.zeros(BATCH, dtype=torch.int64,
                                                   device=pb.device),
                            n_out, g.interp, (ntaps - 1) // 2, ntaps))
        print(f"mix_fir_decimate {label} [{BATCH},{n}] s{g.interp} -> "
              f"[{BATCH},{n_out}]: max abs err {err:.3e} (limit 1e-4); "
              f"wrapper {st['ms']:.4f} ms, kernel alone "
              f"{st['kernel_ms']:.4f} ms, plain {st['plain_ms']:.4f} ms; "
              f"{bound_text(st, st['kernel_ms'])}; library (two calls: cuDNN "
              f"conv1d [{BATCH},1,{n}] x [2,1,{ntaps}] stride {g.interp}, "
              f"then torch.complex * rotation) {st['library_ms']:.4f} ms, "
              f"agrees within {lib_err:.3e}")
        return st

    def data_form(label, pb, osc, rx):
        """The per-row-start data FIR of rx's frame (active_nsymb)."""
        g = rx.geom
        n = pb.shape[1]
        ntaps = rx._fir_data.shape[0]
        frame = g.nofdm * (rx.active_nsymb + g.preamble_nsymb) * g.interp
        start = torch.randint(0, n - frame, (BATCH,), generator=gen,
                              device=pb.device)
        row = dict(start=start, n_out=frame // g.interp,
                   offset=ntaps - 1 - (ntaps - 1) // 2)
        data = (pb, osc, rx._fir_data, g.interp)
        err = (kernels.mix_fir_decimate(*data, **row)
               - kernels.mix_fir_decimate_ref(*data, **row)).abs().max().item()
        assert err <= 1e-4, f"{label} data FIR: max abs err {err}"
        dst = torch.empty((BATCH, row["n_out"]), dtype=torch.complex64,
                          device=pb.device)
        bd = fir_bound(BATCH, n, start, row["n_out"], g.interp, row["offset"],
                       ntaps)
        st = {"data_err": err, "n_data": row["n_out"],
              "data_ms": cuda_ms(lambda: kernels.mix_fir_decimate(*data,
                                                                  **row)),
              "data_kernel_ms": raw_ms(lambda: lib.mfd_launch(
                  pb.data_ptr(), osc.data_ptr(), rx._fir_data.data_ptr(),
                  start.data_ptr(), dst.data_ptr(), BATCH, n, row["n_out"],
                  g.interp, row["offset"], ntaps, kernels._stream(pb))),
              "data_plain_ms": cuda_ms(
                  lambda: kernels.mix_fir_decimate_ref(*data, **row)),
              "data_bound_ms": bd["bound_ms"]}
        print(f"mix_fir_decimate {label} data FIR -> [{BATCH},{row['n_out']}] "
              f"at per-row starts: max abs err {err:.3e} (limit 1e-4); "
              f"wrapper {st['data_ms']:.4f} ms, kernel alone "
              f"{st['data_kernel_ms']:.4f} ms, plain "
              f"{st['data_plain_ms']:.4f} ms; "
              f"{bound_text(bd, st['data_kernel_ms'])}; library: none "
              f"(per-row starts)")
        return st

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
    return out


def check_deep_mf_score(rx: RxChain, gen: torch.Generator,
                        refine_only: dict) -> dict:
    """Whole-buffer scan [256,14824]x[9,4,136] w=7140 and per-candidate
    refine [768,1088]x[3,4,136] w=272 (CONFIG_3, and CONFIG_9's refine),
    and the refine of each chain in refine_only (label -> chain: CONFIG_11
    [768,952]x[3,3,136], CONFIG_13 [768,816]x[3,2,136], CONFIG_16
    [768,680]x[3,1,136]), with planted peaks: argmax equal on every planted
    row, scores within rtol 1e-3 (atol 1e-3)."""
    dev = rx.device
    aliases = (0.0, 93.75, -93.75)
    out = {"max_abs_err": 0.0}
    for label, chain, rows, freqs, window in (
            ("scan", rx, BATCH, np.arange(-4, 5) * 30.0, 7140),
            ("refine", rx, 3 * BATCH, aliases, 272),
            *((f"refine {name}", c, 3 * BATCH, aliases, 272)
              for name, c in refine_only.items())):
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
        print(f"deep_mf_score {label} [{rows},{seg_len}]x{list(bank.shape)} "
              f"w={window}: max abs err {err:.3e}, argmax equal on {rows} "
              f"planted rows; wrapper {k_ms:.4f} ms, kernel alone "
              f"{raw:.4f} ms, plain {p_ms:.4f} ms; "
              f"{mf_tflops(rows, bank.shape, 2 * window + 1, raw):.2f} "
              f"TFLOP/s effective (kernel alone); {bound_text(bd, raw)}; "
              f"library: none; {MF_FORM}")
    out["library_ms"] = None
    return out


def check_deep_mf_max(rx: RxChain, gen: torch.Generator) -> dict:
    """Coherent scan [256,14824]x[61,1,544] w=7140 with one planted peak
    per row: smax within rtol/atol 1e-3; sarg equal on every planted lag and
    wherever the plain top-two margin exceeds 1e-3; argmax over lags equal
    on every planted row."""
    dev = rx.device
    _, bank, _, _ = rx._coherent_banks(8)
    window = 7140
    seg_len = 2 * window + bank.shape[-1]
    seg = torch.complex(torch.randn((BATCH, seg_len), generator=gen,
                                    device=dev),
                        torch.randn((BATCH, seg_len), generator=gen,
                                    device=dev)) * 0.05
    hyp = torch.randint(0, bank.shape[0], (BATCH,), generator=gen, device=dev)
    lag = torch.randint(0, 2 * window + 1, (BATCH,), generator=gen,
                        device=dev)
    idx = lag[:, None] + torch.arange(bank.shape[-1], device=dev)[None]
    seg.scatter_add_(1, idx, bank[hyp, 0])
    smax, sarg = kernels.deep_mf_max(seg, bank, window)
    ref_max, ref_arg = kernels.deep_mf_max_ref(seg, bank, window)
    torch.testing.assert_close(smax, ref_max, rtol=1e-3, atol=1e-3)
    r = torch.arange(BATCH, device=dev)
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
    out.update(mf_bound(BATCH, seg_len, bank.shape, 2 * window + 1, 12))
    print(f"deep_mf_max [{BATCH},{seg_len}]x{list(bank.shape)} w={window}: "
          f"max abs err {err:.3e}; sarg equal on {BATCH} planted lags and "
          f"{int(clear.sum())}/{clear.numel()} lags with a clear margin; "
          f"wrapper {out['ms']:.4f} ms, kernel alone {out['kernel_ms']:.4f} "
          f"ms, plain {out['plain_ms']:.4f} ms; "
          f"{mf_tflops(BATCH, bank.shape, 2 * window + 1, out['kernel_ms']):.2f}"
          f" TFLOP/s effective (kernel alone); "
          f"{bound_text(out, out['kernel_ms'])}; library: none; {MF_FORM}")
    return out


def check_pilot_cand_score(rx: RxChain, gen: torch.Generator) -> dict:
    """[256,14824] rows, M=32, bank [61,48,136]: row 1 half-silent, row 2
    silent, candidates clipped at both ends; rtol 1e-4, atol 1e-5. The
    prepared bank comes from the chain's cache, as on the path."""
    dev = rx.device
    _, _, bank, prepared = rx._coherent_banks(8)
    n_dec, m = 14824, 32
    f_n, nsym, s_d = bank.shape
    span = nsym * s_d
    bb = torch.complex(torch.randn((BATCH, n_dec), generator=gen, device=dev),
                       torch.randn((BATCH, n_dec), generator=gen, device=dev))
    bb[1, n_dec // 2:] = 0
    bb[2] = 0
    idx0 = torch.randint(0, n_dec - span + 1, (BATCH, m), generator=gen,
                         device=dev)
    idx0[:, 0] = -100
    idx0[:, 1] = n_dec
    fidx = torch.randint(0, f_n, (BATCH, m), generator=gen, device=dev)
    args = (bb, idx0, fidx, bank)
    got = kernels.pilot_cand_score(*args, prepared)
    want = kernels.pilot_cand_score_ref(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert (got[2] == 0).all() and (got[0] > 0).all()
    err = (got - want).abs().max().item()
    # the kernel alone (it clips the candidates itself)
    lib = native.load_library()
    res = torch.empty_like(got)
    ptrs = [t.data_ptr() for t in (bb, idx0, fidx, *prepared, res)]
    out = {"max_abs_err": err,
           "ms": cuda_ms(lambda: kernels.pilot_cand_score(*args, prepared)),
           "kernel_ms": raw_ms(lambda: lib.pcs_launch(
               *ptrs, BATCH, n_dec, n_dec, 1, m, f_n, nsym, s_d,
               kernels._stream(bb))),
           "plain_ms": cuda_ms(lambda: kernels.pilot_cand_score_ref(*args)),
           "library_ms": None}
    # compulsory bytes: each row's samples under some candidate, the bank
    # rows referenced, starts, rows, energies and scores; flops: 8 per
    # complex multiply-add and 4 per sample energy
    st, fr = kernels._clip_candidates(n_dec, idx0, fidx, bank)
    cover = torch.zeros((BATCH, n_dec + 1), dtype=torch.int32, device=dev)
    one = torch.ones_like(st, dtype=torch.int32)
    cover.scatter_add_(1, st, one)
    cover.scatter_add_(1, st + span, -one)
    row_samples = int((cover.cumsum(1)[:, :n_dec] > 0).sum())
    n_rows_used = int(torch.unique(fr).numel())
    out.update(bound(8 * row_samples + 8 * n_rows_used * span
                     + 16 * BATCH * m + 4 * nsym + 4 * BATCH * m,
                     12.0 * BATCH * m * span, "FP32"))
    print(f"pilot_cand_score [{BATCH},{n_dec}] M={m} x{list(bank.shape)}: "
          f"max abs err {err:.3e} (bursty, silent and clipped cases); "
          f"wrapper {out['ms']:.4f} ms, kernel alone {out['kernel_ms']:.4f} "
          f"ms, plain {out['plain_ms']:.4f} ms; "
          f"{bound_text(out, out['kernel_ms'])} ({n_rows_used} bank rows "
          f"referenced; templates read per (row, candidate): "
          f"{8 * BATCH * m * span / 1e6:.1f} MB); library: none")
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
                 chains, gen, PatternSignaler(build_geometry(0), device=dev)),
             "deep_mf_score": check_deep_mf_score(rx3, gen, refine_only),
             "deep_mf_max": check_deep_mf_max(rx0, gen),
             "pilot_cand_score": check_pilot_cand_score(rx0, gen)}
    del rx0, rx3, refine_only, chains
    torch.cuda.empty_cache()

    # each path from counts of 0, read just after it; the kernels line
    # reports each kernel's launches summed over the paths
    runs = [drive_main_path(cfg, dev)["launches"]
            for cfg in (3, 9, 0, 16, 13, 11, 100, 101, 102)]
    runs += [drive_main_path(cfg, dev, ctrl=True)["launches"]
             for cfg in (100, 101)]
    runs.append(drive_rescue(dev)["launches"])
    runs.append(drive_near_threshold(dev)["launches"])
    runs.append(drive_second_candidate(dev)["launches"])
    runs.append(drive_patterns(dev)["launches"])
    runs.append(drive_fading(dev)["launches"])
    launches = {k: sum(r[k] for r in runs) for k in KERNELS}
    for cfg in (0, 3, 9):
        decode_golden(cfg, dev)
    for cfg in (*range(10, 17), 100, 101, 102):
        for density in (HIGH_DENSITY, LOW_DENSITY):
            decode_golden(cfg, dev, density)
    for cfg in (15, 16):                # zero-forcing, as the reference
        decode_golden(cfg, dev, estimator="reference")
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
