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
     and deep_mf_best (the best lag of each hypothesis: bit-equal to
     deep_mf_score's surface, its first argmax and the score there) also
     at the refine shapes of CONFIG_11 (three preamble symbols), 13 (two)
     and 16 (one), and at refine_decode's full-rate shape;
     ldpc_layered (the layered LDPC decode, one launch a decode) at every
     code rate, SPA and min-sum, at batch 256 with mixed noise (rows that
     converge and rows that do not) and at batch 1, and SPA after one and
     after three sweeps (roofline.ldpc_agree): min-sum bit-exact; SPA ok
     different on at most 1% of the rows (rounded down), bits equal where
     both converged, posterior signs equal where both converged at the
     same sweep, and over at most three sweeps iters within one and the
     posterior within the limit and share of roofline.LDPC_POST_BARS;
     one decode under torch.profiler shows the kernel and no cumprod,
     atanh or index_add; every LDPC line (here and each path shape of
     4) names the launch geometry the plan took (ldpc_layout);
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
     three-frame stream; rx_diagnostics's bars; two link sessions, two
     ArqTcpServers over localhost and the three serving pools at 256
     channels of CONFIG_9; FusedDevicePool at CONFIG_3 at the benchmark's
     c3_pool_scan size (POOL_SCAN_CHANNELS, Es/N0 0.75 dB), whose scan and
     refinement launch shapes 4 holds. Then the sharded receive on virtual
     meshes of the one card (scale.shard; every shard a chain and a stream of its
     own, the shards driven in turn): channel-parallel CONFIG_9 at 12 dB on 1, 2 and 4 shards
     (the unsharded receive's bytes), CONFIG_0 as 4 shards x 64 rows, and
     spmd_overhead_curve at a total batch of 256; time_sharded_receive
     over 4 shards of CONFIG_9 (256 streams) and CONFIG_0 (64), with frames
     straddling seams and frames 8 and 4 samples before a seam, each frame
     claimed exactly once and the claims those of plain receives of each
     shard's window; time_sharded_receive_stream on CONFIG_16, K = 3
     blocks, 256 streams, its halo copies profiled (their overlap with the
     decodes' kernels, a same-card copy rate into
     analysis.predicted_efficiency); a 2 x 2 (dcn, t) mesh; then meshes
     over two processes (scale.dist's launcher starts 2 ranks of
     rank_forms: on one card both over gloo, CUDA tensors through host
     memory; NCCL with a card a rank): that 2 x 2 mesh with dcn across the
     ranks, CONFIG_9's time axis across them, CONFIG_0 channel-parallel,
     each rank's claims and payloads equal to the one-process form's, each
     form's wall beside it, the ranks' idle shares, peak memory, their
     link rate and the kernel shapes they launched held in the ranks;
     time_sharded_fir
     against the unsharded FIR; deep_profile "c2f" and "full" at CONFIG_3;
     the legacy GI metrics and coherent_preamble_rescore against the CPU.
     Then the measuring entry points as a user runs them: `python -m
     mercury_tpu_torch -m BENCH` in-process (its JSON line printed, every
     warm-up row decoded; then its receive timed between synchronizes and
     profiled), tools.throughput_table in --quick form over
     all 20 modes and CONFIG_0 with deep sync off (every row decoded),
     tools.serve_bench's fused and device pools at 256 channels (every
     channel decoded every round) and one adaptive tools.link_benchmark
     session (CONFIG_0, 20 dB, 2000 bytes intact). Then the qualification
     tools at short sizes: one ber_campaign job (CONFIG_9 passband: a
     waterfall within 1 dB of the documented Es/N0), one ber_sweep config
     (CONFIG_9: FER 0 at its grid's top point), the ACK/BREAK
     pattern sweep (CONFIG_100, -2..0 dB, 64 trials), one fading_ber point
     (CONFIG_9, "good", 18 dB), audio_stress through the audio engine (120
     bytes, a noise burst forcing a BREAK and a gearshift down) and the
     roofline, every stage timed, each share at or below 105% of its
     bound (the tool's bound() is this script's);
  3. decodes the reference's CONFIG_0, 3 and 9 capture buffers, those of
     CONFIG_10-16 and 100-102 at both pilot densities, and CONFIG_15/16's
     with the zero-forcing estimator (tests/golden), to their reference
     bytes;
  4. holds each kernel shape that the paths of 2 and 3 launched and
     phase 1 did not hold against its plain version, on the operands of
     its first call there (ShapeLog, hold_path_shapes), mix_fir_decimate's
     strided "same" form also against the cuDNN yardstick.
Any failure raises (non-zero exit). Without a CUDA device it exits non-zero
before printing a result. The line before the last lists the kernels
(launches on the main paths, error, times, bound, library time); the last
line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import gc
import inspect
import io
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

from mercury_tpu_torch import __main__ as cli
from mercury_tpu_torch import bench, native, obs
from mercury_tpu_torch.bench import make_buffer
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.core.modes import HIGH_DENSITY, LOW_DENSITY
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.channel.ber import BerHarness
from mercury_tpu_torch.dsp import kernels, ops
from mercury_tpu_torch.fec import ldpc
from mercury_tpu_torch.link import protocol as P
from mercury_tpu_torch.link.node import ArqConfig, ArqNode
from mercury_tpu_torch.link.sim import ChannelModel, LinkSimulator
from mercury_tpu_torch.link.tcp_api import ArqTcpServer
from mercury_tpu_torch.link.transport import PairTransport
from mercury_tpu_torch.modem import sync
from mercury_tpu_torch.modem.patterns import PatternSignaler
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.stream import StreamReceiver
from mercury_tpu_torch.modem.tx import TxChain
from mercury_tpu_torch.scale import analysis, dist, serve, shard
from mercury_tpu_torch.tools import audio_stress, ber_campaign, ber_sweep
from mercury_tpu_torch.tools import fading_ber, link_benchmark
from mercury_tpu_torch.tools import pattern_detect_sweep, roofline
from mercury_tpu_torch.tools import serve_bench, throughput_table
# one yardstick: the roofline tool's bound, counts, raw launches and timer
from mercury_tpu_torch.tools.roofline import (LDPC_FEW_SWEEPS, checked,
                                              fir_bound, fir_raw, ldpc_agree,
                                              ldpc_bound, ldpc_mixed_llr,
                                              ldpc_raw, mf_bound, mf_raw,
                                              pcs_bound, pcs_raw, warm_ms)

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
    "deep_mf_best": ("mercury_tpu_torch/csrc/deep_mf_score.cu",
                     "mercury_tpu/modem/sync.py:197"),
    "pilot_cand_score": ("mercury_tpu_torch/csrc/pilot_cand_score.cu",
                         "mercury_tpu/dsp/pallas_kernels.py:573"),
    "ldpc_layered": ("mercury_tpu_torch/csrc/ldpc_layered.cu",
                     "mercury_tpu/fec/ldpc.py:386"),
}
# the function of `kernels` that launches a kernel, where it is not the
# kernel's name (deep_mf_best chooses between its kernel and the surface)
LAUNCHER = {"deep_mf_best": "deep_mf_best_fused"}
# the noncoherent matched filter: deep_mf_best's kernel where the rows fill
# the card (kernels._best_rows: the pool's scans, refines of 768 rows), else
# deep_mf_score's surface and its argmax (a link's few rows, refine_decode)
MF = ("deep_mf_best", "deep_mf_score")
# the kernels each receive path must launch (of a tuple, any one)
PATH_KERNELS = {3: ("mix_fir_decimate", MF, "ldpc_layered"),
                9: ("mix_fir_decimate", MF, "ldpc_layered"),
                0: ("mix_fir_decimate", "deep_mf_max", "pilot_cand_score",
                    "ldpc_layered"),
                16: ("mix_fir_decimate", MF, "ldpc_layered"),
                13: ("mix_fir_decimate", MF, "ldpc_layered"),
                11: ("mix_fir_decimate", MF, "ldpc_layered"),
                100: ("mix_fir_decimate", "ldpc_layered"),
                101: ("mix_fir_decimate", "ldpc_layered"),
                102: ("mix_fir_decimate", "ldpc_layered")}


def path_ran(n: dict, cfg: int, least: int = 1) -> bool:
    """Whether launch counts n hold every kernel PATH_KERNELS[cfg] names,
    each (of a tuple, the alternatives together) at least `least` times."""
    return all(sum(n[x] for x in ((k,) if isinstance(k, str) else k))
               >= least for k in PATH_KERNELS[cfg])
# the code rates of the layered LDPC decode (every rate a config uses)
LDPC_RATES = (1, 2, 3, 4, 5, 6, 8, 14)
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
    if name == "ldpc_layered":
        plan = a["plan"]
        return (a["llr"].shape[0], f"rate {plan.rate_num}",
                f"{plan.n_layers} layers", a["algo"],
                "soft" if a["soft"] else "hard", ldpc_layout(plan))
    return (*a["seg"].shape, *a["bank"].shape, a["window"])


def ldpc_layout(plan) -> str:
    """The launch geometry ldpc_layered takes for a plan (a block a row)."""
    geo = plan.geometry
    return (f"{geo.row_threads} threads a row, {geo.checks_lane} checks x "
            f"{geo.slots_lane} edges a lane, {geo.passes} pass(es), "
            f"{geo.shared_bytes} B shared")


def _copy(v):
    """A tensor copied at its own strides (a tuple of them each), else v."""
    if isinstance(v, tuple):
        return tuple(_copy(x) for x in v)
    if not torch.is_tensor(v):
        return v
    return torch.empty_strided(v.shape, v.stride(), dtype=v.dtype,
                               device=v.device).copy_(v)


class ShapeLog:
    """The launch shapes of the kernels. Each wrapper in `kernels` is
    replaced by one that notes the shape (shape_key) of every call on the
    card, then calls the wrapper (whose launch count is its own). While
    `path` is None (phase 1) a shape is noted as held against the plain
    version; on a path, every shape's launches are counted, and a shape
    phase 1 did not hold keeps the first path to launch it and a copy of
    its first call's operands, which hold_path_shapes holds against the
    plain version. The TCP phase calls the wrappers from a thread a node:
    a lock guards the notes."""

    def __init__(self):
        self.wrappers = {name: getattr(kernels, LAUNCHER.get(name, name))
                         for name in KERNELS}
        self._lock = threading.Lock()
        self.held = set()
        self.path = None
        self.unheld = {}
        self.launches = {}
        for name, fn in self.wrappers.items():
            setattr(kernels, LAUNCHER.get(name, name), self._noting(name, fn))

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
        with self._lock:
            if self.path is None:
                self.held.add(key)
                return
            self.launches[key] = self.launches.get(key, 0) + 1
            if key not in self.held and key not in self.unheld:
                self.unheld[key] = {"path": self.path, "args": {
                    k: _copy(v) for k, v in a.items()}}


def best_agree(seg, bank, window: int, lag, got, want_lag, want,
               label: str, surface_fn=None) -> tuple[float, str]:
    """deep_mf_best's (lag, score) against deep_mf_score's surface on the
    card (surface_fn: that wrapper, kernels' by default), its first argmax
    over the lags and the score there: bit-equal
    (the same TF32 products, summed over K and the parts in the same
    order); against the plain version (want_lag, want): scores within rtol
    and atol 1e-3, lags equal wherever the plain surface's top two differ
    by more than 1e-3. -> (max abs err against the plain version, text)."""
    surface = (surface_fn or kernels.deep_mf_score)(seg, bank, window)
    s_lag = surface.argmax(-1)
    s_best = torch.gather(surface, -1, s_lag[..., None])[..., 0]
    assert torch.equal(lag, s_lag), (
        f"{label}: lag differs from the surface's argmax on "
        f"{int((lag != s_lag).sum())} of {lag.numel()}")
    assert torch.equal(got, s_best), (
        f"{label}: score not bit-equal to the surface's, max abs "
        f"{(got - s_best).abs().max().item():.3e}")
    del surface
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    top2 = kernels.deep_mf_score_ref(seg, bank, window).topk(2, dim=-1).values
    clear = top2[..., 0] - top2[..., 1] > 1e-3
    assert torch.equal(lag[clear], want_lag[clear]), (
        f"{label}: lag differs from the plain version's at a clear peak")
    return ((got - want).abs().max().item(),
            f"bit-equal to the surface's argmax and score; within rtol/atol "
            f"1e-3 of the plain version, lags equal on {int(clear.sum())}/"
            f"{clear.numel()} clear (row, hypothesis)")


def hold_path_shapes(log: ShapeLog) -> dict:
    """Every shape a path launched that phase 1 did not hold, on the
    operands of its first call there: the wrapper against the plain
    version at phase 1's tolerances (mix_fir_decimate within 1e-4 of
    max(1, the output's scale); the matched filters rtol and atol 1e-3,
    with the argmax equal wherever the plain version's top two differ by
    more than 1e-3, deep_mf_best also bit-equal to deep_mf_score's
    surface, its argmax and the score there (best_agree); pilot_cand_score
    rtol 1e-4, atol 1e-5), each timed
    through the wrapper, alone and plain (5 launches each) beside its
    bound; ldpc_layered as ldpc_agree holds it (min-sum bit-exact), its
    plain version timed once. -> {"name shape": figures}."""
    out = {}
    for (name, key), entry in sorted(log.unheld.items(), key=str):
        a = entry["args"]
        wrapper = log.wrappers[name]
        plain = (kernels.layered_decode_ref if name == "ldpc_layered"
                 else getattr(kernels, f"{name}_ref"))
        pa = {k: v for k, v in a.items() if k != "prepared"}
        lib_ms = None
        plain_reps = 5
        if name == "ldpc_layered":
            got = wrapper(**a)
            want, p_ms = event_ms(lambda: plain(**pa))
            err, text = ldpc_agree(got, want, a["algo"], f"{name} {key}",
                                   a["max_iter"])
            bd = ldpc_bound(**a, iters=got[1])
            raw = ldpc_raw(**a)
            text += f"; {bd['sweeps']:.2f} sweeps a row"
            plain_reps = 0
        elif name == "mix_fir_decimate":
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
            library = fir_path_library(a, limit, got)
            if library is not None:
                lib_ms = warm_ms(library, 5)
                text += (f"; library (cuDNN conv1d + rotation) {lib_ms:.4f} "
                         f"ms, agrees within {limit:.3e}")
        elif name == "pilot_cand_score":
            got, want = wrapper(**a), plain(**pa)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
            err = (got - want).abs().max().item()
            bd = pcs_bound(a["bb_dec"], a["idx0"], a["fidx"], a["bank"])
            raw = pcs_raw(**a)
            text = "within rtol 1e-4, atol 1e-5"
        elif name == "deep_mf_best":
            seg, bank, window = a["seg"], a["bank"], a["window"]
            (lag, got), (want_lag, want) = wrapper(**a), plain(**pa)
            err, text = best_agree(seg, bank, window, lag, got, want_lag,
                                   want, f"{name} {key}",
                                   log.wrappers["deep_mf_score"])
            outs = [torch.empty_like(got), torch.empty_like(lag)]
            bd = mf_bound(seg.shape[0], seg.shape[1], bank.shape,
                          2 * window + 1, 12, per_lag=False)
            raw = mf_raw(name, seg, bank, window, outs)
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
              "max_abs_err": err, "ms": warm_ms(lambda: wrapper(**a), 5),
              "kernel_ms": warm_ms(checked(raw, name), 5),
              "plain_ms": (warm_ms(lambda: plain(**pa), plain_reps)
                           if plain_reps else p_ms),
              "library_ms": lib_ms, **bd}
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


def fir_path_library(a: dict, limit: float, got: torch.Tensor):
    """fir_library for a path's mix_fir_decimate call (its wrapper's
    arguments a) in the strided "same" form, every row from 0 without
    per-row offsets, whose oscillator is the standard carrier's table (no
    chain here has a carrier offset): held to agree with the kernel's
    output got within limit. None for the other forms: no library call
    takes per-row starts or offsets."""
    if a["start"] is not None or a["freq"] is not None:
        return None
    pb, osc = a["pb"], a["osc"]
    n = pb.shape[1]
    g = build_geometry(9, with_pre_eq=False)
    if osc.shape[0] != n or not torch.equal(
            osc, ops.mixer_table(n, g.fc, g.fs, osc.device)):
        return None
    library = fir_library(pb, osc, a["taps"], a["stride"], g)
    err = (library() - got).abs().max().item()
    assert err <= limit, f"conv1d yardstick differs by {err} at {pb.shape}"
    return library


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
              "ms": warm_ms(lambda: kernels.mix_fir_decimate(*args, **kw), 10),
              "kernel_ms": warm_ms(checked(fir_raw(*args, **kw), label), 20),
              "plain_ms": warm_ms(lambda: kernels.mix_fir_decimate_ref(
                  *args, **kw), 10),
              "library_ms": None}
        lib_text = "library: none (per-row offsets)"
        if not freq:
            library = fir_library(*args, g)
            lib_err = (library() - kernels.mix_fir_decimate(*args)).abs().max(
                ).item()
            assert lib_err <= 1e-4, (
                f"{label}: conv1d yardstick differs by {lib_err}")
            st["library_ms"] = warm_ms(library, 10)
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
              "data_ms": warm_ms(lambda: kernels.mix_fir_decimate(*data,
                                                                  **row), 10),
              "data_kernel_ms": warm_ms(checked(fir_raw(*data, **row), label),
                                        20),
              "data_plain_ms": warm_ms(
                  lambda: kernels.mix_fir_decimate_ref(*data, **row), 10),
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
                        refine_only: dict, rx9: RxChain
                        ) -> tuple[dict, dict]:
    """Whole-buffer scan [256,14824]x[9,4,136] w=7140 and per-candidate
    refine [768,1088]x[3,4,136] w=272 (CONFIG_3, and CONFIG_9's refine),
    the refine of each chain in refine_only (label -> chain: CONFIG_11
    [768,952]x[3,3,136], CONFIG_13 [768,816]x[3,2,136], CONFIG_16
    [768,680]x[3,1,136]), and refine_decode's full-rate shape on rx9
    (CONFIG_9: [256,4864]x[1,4,1088] w=256, 513 lags: not a multiple of
    the kernel's 256-lag tile); and the link's sizes: a batch-1 receive's
    refine ([3,1088]x[3,4,136]) and refine_decode over a batch_size-5
    block's siblings ([5,4864]x[1,4,1088]); with planted peaks: argmax
    equal on every planted row, scores within rtol 1e-3 (atol 1e-3). And
    deep_mf_best on the same operands (best_agree; its planted lags equal
    the plants). -> (deep_mf_score's figures, deep_mf_best's)."""
    dev = rx.device
    aliases = (0.0, 93.75, -93.75)
    out = {"max_abs_err": 0.0, "shapes": {}}
    best = {"max_abs_err": 0.0, "shapes": {}, "library_ms": None}
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
        k_ms = warm_ms(lambda: kernels.deep_mf_score(seg, bank, window), 5)
        raw = warm_ms(checked(mf_raw("deep_mf_score", seg, bank, window,
                                     [torch.empty_like(got)]), label), 5)
        p_ms = warm_ms(lambda: kernels.deep_mf_score_ref(seg, bank, window), 5)
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
        del got, want
        b_lag, b_got = kernels.deep_mf_best_fused(seg, bank, window)
        want_lag, b_want = kernels.deep_mf_best_ref(seg, bank, window)
        assert torch.equal(b_lag[r, hyp], lag), f"{label}: planted lags"
        b_err, text = best_agree(seg, bank, window, b_lag, b_got, want_lag,
                                 b_want, f"deep_mf_best {label}")
        best["max_abs_err"] = max(best["max_abs_err"], b_err)
        bk_ms = warm_ms(lambda: kernels.deep_mf_best(seg, bank, window), 5)
        b_raw = warm_ms(checked(mf_raw(
            "deep_mf_best", seg, bank, window,
            [torch.empty_like(b_got), torch.empty_like(b_lag)]), label), 5)
        bp_ms = warm_ms(lambda: kernels.deep_mf_best_ref(seg, bank, window),
                        5)
        b_bd = mf_bound(rows, seg_len, bank.shape, 2 * window + 1, 12,
                        per_lag=False)
        if label == "scan":
            best.update(b_bd, ms=bk_ms, kernel_ms=b_raw, plain_ms=bp_ms)
        # the rows from which the wrapper takes the kernel (0: never)
        takes = kernels._best_rows(dev, *bank.shape, 2 * window + 1)
        best["shapes"][label] = {"ms": bk_ms, "kernel_ms": b_raw,
                                 "plain_ms": bp_ms,
                                 "bound_ms": b_bd["bound_ms"],
                                 "max_abs_err": b_err, "kernel_from": takes}
        print(f"deep_mf_best {label} [{rows},{seg_len}]x{list(bank.shape)} "
              f"w={window}: {text}, max abs err {b_err:.3e}; wrapper "
              f"({'kernel' if 0 < takes <= rows else 'surface'}: the "
              f"kernel from {takes} rows) "
              f"{bk_ms:.4f} ms, kernel alone {b_raw:.4f} ms, plain "
              f"{bp_ms:.4f} ms; "
              f"{mf_tflops(rows, bank.shape, 2 * window + 1, b_raw):.2f} "
              f"TFLOP/s effective (kernel alone); {bound_text(b_bd, b_raw)}")
    out["library_ms"] = None
    return out, best


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
           "ms": warm_ms(lambda: kernels.deep_mf_max(seg, bank, window), 5),
           "kernel_ms": warm_ms(checked(mf_raw(
               "deep_mf_max", seg, bank, window,
               [torch.empty_like(smax), torch.empty_like(sarg)]),
               "deep_mf_max"), 5),
           "plain_ms": warm_ms(
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
           "ms": warm_ms(lambda: kernels.pilot_cand_score(*args, prepared),
                         10),
           "kernel_ms": warm_ms(checked(pcs_raw(*args, prepared),
                                        "pilot_cand_score"), 20),
           "plain_ms": warm_ms(lambda: kernels.pilot_cand_score_ref(*args),
                               10),
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


def event_ms(fn) -> tuple:
    """fn() once between two CUDA events -> (its result, device ms; the
    host's waits inside fn count)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = fn()
    e1.record()
    torch.cuda.synchronize()
    return res, e0.elapsed_time(e1)


def check_ldpc_layered(dev: torch.device) -> dict:
    """The layered LDPC decode on every rate, SPA and min-sum, with the
    posterior out (BICM-ID's call): batch 256 at mixed noise
    (roofline.ldpc_mixed_llr: rows that converge within the 50 sweeps and
    rows that do not), SPA also after one and after LDPC_FEW_SWEEPS sweeps,
    and batch 1 (a link node's) on the row that the plain decode at batch
    256 converged in the fewest sweeps: the kernel against
    layered_decode_ref on the card as roofline.ldpc_agree holds it
    (min-sum bit-exact; SPA element by element over few sweeps). A decode
    is one launch, and a torch.profiler trace of one (rate 8, SPA) lists
    no cumprod, atanh or index_add. Each case's wrapper ms and kernel alone
    (raw launch) over 5 launches, plain ms (one call), mean sweeps and
    bound. -> rate 8/16 SPA at batch 256 (CONFIG_9's decode) as the kernels
    line's entry, its max_abs_err the largest posterior gap of rate 8/16
    SPA's decodes held element by element, every case under "cases"."""
    cases = {}
    for rate in LDPC_RATES:
        cw, llr_all = ldpc_mixed_llr(rate, BATCH, seed=rate)
        llr_all = llr_all.to(dev)
        for algo in ("spa", "minsum"):
            runs = [("batch 256", 50)]
            if algo == "spa":
                runs += [("one sweep", 1),
                         (f"{LDPC_FEW_SWEEPS} sweeps", LDPC_FEW_SWEEPS)]
            runs.append(("batch 1", 50))
            for label, max_iter in runs:
                llr = llr_all
                if label == "batch 1":
                    it = cases[f"rate {rate}/16 {algo} batch 256"]["iters"]
                    row = int(torch.where(it > 0, it, 1 << 20).argmin())
                    llr = llr_all[row: row + 1]
                dec = ldpc.LayeredDecoder(rate, max_iter, algo=algo).to(dev)
                before = kernels.LAUNCHES["ldpc_layered"]
                got = dec(llr, soft=True)
                assert kernels.LAUNCHES["ldpc_layered"] == before + 1
                args = dict(llr=llr, plan=dec.plan, max_iter=max_iter,
                            algo=algo, alpha=dec.alpha, beta=dec.beta,
                            soft=True)
                want, p_ms = event_ms(
                    lambda: kernels.layered_decode_ref(**args))
                name = f"rate {rate}/16 {algo} {label}"
                err, text = ldpc_agree(got, want, algo, name, max_iter)
                if label == "batch 256":
                    assert got[2].any() and not got[2].all(), name
                if label == "batch 1":
                    text += f" (row {row})"
                bd = ldpc_bound(**args, iters=got[1])
                st = {"max_abs_err": err, "plain_ms": p_ms,
                      "ms": warm_ms(lambda: dec(llr, soft=True), 5),
                      "kernel_ms": warm_ms(checked(ldpc_raw(**args), name),
                                           5),
                      "ok": int(got[2].sum()), "library_ms": None,
                      "iters": want[1], **bd}
                cases[name] = st
                print(f"ldpc_layered {name} [{llr.shape[0]},1600], "
                      f"{dec.n_layers} layers ({ldpc_layout(dec.plan)}"
                      f"): {text}; {st['ok']}/"
                      f"{llr.shape[0]} rows converged, {bd['sweeps']:.2f} "
                      f"sweeps a row; wrapper {st['ms']:.4f} ms, kernel "
                      f"alone {st['kernel_ms']:.4f} ms, plain {p_ms:.2f} "
                      f"ms; {bound_text(bd, st['kernel_ms'])}; library: "
                      f"none (no PyTorch call decodes LDPC)")
    # one decode under the profiler: the kernel and no torch arithmetic
    dec = ldpc.LayeredDecoder(8).to(dev)
    llr = ldpc_mixed_llr(8, BATCH, seed=8)[1].to(dev)
    dec(llr)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        dec(llr)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    dev_ops = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    banned = [n for n in names if any(k in n for k in (
        "cumprod", "atanh", "index_add"))]
    assert not banned and any("ldpc_layered" in n for n in dev_ops), (
        banned, dev_ops)
    print(f"ldpc_layered: one decode (rate 8/16 SPA, batch 256) under "
          f"torch.profiler: {len(dev_ops)} device operations "
          f"{sorted(set(dev_ops))}; no cumprod, atanh or index_add")
    held = max(cases[f"rate 8/16 spa {label}"]["max_abs_err"] for label in
               ("one sweep", f"{LDPC_FEW_SWEEPS} sweeps"))
    for st in cases.values():
        del st["iters"]
    return {**cases["rate 8/16 spa batch 256"], "max_abs_err": held,
            "cases": cases}


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
    assert path_ran(launches, cfg), (
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
    assert path_ran(launches, 0), launches
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
    assert path_ran(launches, 16), launches
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


def profile_busy(fn) -> tuple:
    """fn() once under torch.profiler, ending in a synchronize -> (its
    result, device busy ms: the table's "Self CUDA time total" less NCCL's
    kernels, host ms of the call, NCCL's kernels' ms: an NCCL kernel
    spins on the card while it waits for its peer)."""
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=3)
    m = re.search(r"Self CUDA time total: ([\d.]+)(s|ms|us)", table)
    assert m, f"the profiler saw no device time:\n{table}"
    busy = float(m.group(1)) * {"s": 1e3, "ms": 1.0, "us": 1e-3}[m.group(2)]
    nccl = sum(e.self_device_time_total for e in prof.key_averages()
               if e.key.startswith(("ncclDevKernel", "ncclKernel"))) / 1e3
    return res, busy - nccl, wall, nccl


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
        assert path_ran(n, cfg), n
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
    _res, busy, wall, _nccl = profile_busy(lambda: receive(quiet))
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
    (_, packed), busy, _wall, _nccl = profile_busy(
        lambda: one_round(again, 3))
    fb5 = g.frame_bytes + 5
    assert torch.equal(packed[:, :fb5], packed3[:, :fb5]), (
        "round 3's payload, ok or delay differs on the second pool")
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
    assert path_ran(launches, 9), launches
    print(f"pools: launches {launches}")
    return {"launches": launches, **out}


def sharded_stream(g, dev: torch.device, n_rows: int, plan: dict,
                   n_slices: int, esn0: float, seed: int):
    """n_rows streams of n_slices slices of the standard buffer at Es/N0
    esn0, with frames (random payloads) at plan's starts: {(row, key):
    start} -> (stream [n_rows, n_slices * n_local], payloads {(row, key):
    [frame_bytes]})."""
    n = g.nofdm * g.buffer_nsymb * g.interp
    gen = torch.Generator(device=dev).manual_seed(seed)
    keys = list(plan)
    payload = torch.randint(0, 256, (len(keys), g.frame_bytes),
                            generator=gen, device=dev, dtype=torch.uint8)
    frames = TxChain(g, device=dev).transmit(payload)
    stream = sim.sigma_for_esn0(esn0) * torch.randn(
        (n_rows, n_slices * n), generator=gen, device=dev)
    for i, key in enumerate(keys):
        st = plan[key]
        stream[key[0], st: st + frames.shape[1]] += frames[i]
    return stream, dict(zip(keys, payload))


def ts_plan(g, n_rows: int, n_dev: int) -> dict:
    """Frame starts of time_sharded_receive's check over n_dev slices of
    n_local: even rows a frame in each even slice (2000 + 37 (r % 50)
    samples after the end of the frame straddling into it) and one
    straddling each odd slice's right seam (1/3 of a frame before it; the
    last slice's frame stays inside it); odd rows one 8 samples
    before the first seam and (with 4 slices or more) one 4 samples before
    the third, each claimed
    by one of the two slices at its seam: the left one where its
    matched-filter peak falls below the seam (and the right one's decode
    of it is dropped by the dedupe), else the right one. -> {(row, slice,
    or "0|1" and "2|3"): start}."""
    n = g.nofdm * g.buffer_nsymb * g.interp
    fl = g.nofdm * (g.nsymb + g.preamble_nsymb) * g.interp
    plan = {}
    for r in range(n_rows):
        if r % 2 == 0:
            for j in range(n_dev):
                if j % 2 == 0:
                    plan[r, j] = j * n + 2 * fl // 3 + 2000 + 37 * (r % 50)
                elif j < n_dev - 1:
                    plan[r, j] = (j + 1) * n - fl // 3
                else:
                    plan[r, j] = (j + 1) * n - fl - 100
        else:
            plan[r, "0|1"] = n - 8
            if n_dev > 3:
                plan[r, "2|3"] = 3 * n - 4
    return plan


def check_claims(label: str, res, plan: dict, payloads: dict, n_dev: int,
                 blocks: int = 1) -> dict:
    """Every planted frame claimed exactly once, by its slice (or either of
    "0|1" and "2|3"), with its payload, within 16 samples; no other claim.
    res fields [K, n_dev, B] (K = blocks) or [n_dev, B]. -> counts: frames,
    claimed, and dedupes (a seam frame whose right-hand slice decoded it
    too, its claim dropped)."""
    claim = res.crc_ok.reshape(blocks * n_dev, -1).cpu()
    delay = res.delay.reshape(blocks * n_dev, -1).cpu()
    pay = res.payload.reshape(blocks * n_dev, res.payload.shape[-2],
                              -1).cpu()
    seen = set()
    dedupes = 0
    for (r, key), start in plan.items():
        slices = ((int(key[0]), int(key[2])) if isinstance(key, str)
                  else (key,))
        got = [s for s in slices if bool(claim[s, r])]
        assert len(got) == 1, f"{label}: row {r} frame {key} claimed by {got}"
        s = got[0]
        seen.add((s, r))
        assert abs(int(delay[s, r]) - start) <= 16, (
            f"{label}: row {r} frame {key}: delay {int(delay[s, r])} for "
            f"start {start}")
        assert torch.equal(pay[s, r], payloads[r, key].cpu()), (
            f"{label}: row {r} frame {key}: payload differs")
        if len(slices) == 2 and s == slices[0]:
            dedupes += int(torch.equal(pay[slices[1], r],
                                       payloads[r, key].cpu()))
    extra = int(claim.sum()) - len(seen)
    assert extra == 0, f"{label}: {extra} claims of no planted frame"
    return {"frames": len(plan), "claimed": len(seen), "dedupes": dedupes}


def plain_claims(rx, stream, n_dev: int, halo: int, sym: int) -> tuple:
    """What time_sharded_receive must claim, from plain receives: slice j
    of stream [B, n_dev * n] with the next `halo` samples (zeros past the
    end) through rx.receive(sync_limit=n); a claim is a CRC pass starting
    inside the slice, its delay global, dropped where the slice to its left
    raw-claimed a frame within one symbol. -> (claims bool [n_dev, B],
    delays int32 [n_dev, B], payloads [n_dev, B, frame_bytes])"""
    b, total = stream.shape
    n = total // n_dev
    padded = torch.cat([stream, stream.new_zeros(b, halo)], dim=-1)
    claims, delays, pays, raw = [], [], [], None
    for j in range(n_dev):
        res = rx.receive(padded[:, j * n: (j + 1) * n + halo], sync_limit=n)
        gd = (j * n + res.delay).to(torch.int32)
        claim = res.crc_ok & (res.delay < n)
        kept = claim if raw is None else claim & ~(
            raw & ((delays[-1] - gd).abs() < sym))
        raw = claim
        claims.append(kept)
        delays.append(gd)
        pays.append(res.payload)
    return torch.stack(claims), torch.stack(delays), torch.stack(pays)


# the benchmark's c3_pool_scan cell: its channels, chunk and lead symbols
# and Es/N0 (benchmark/workloads/c3_pool_scan.json)
POOL_SCAN_CHANNELS = 1024
POOL_SCAN_CHUNK, POOL_SCAN_LEAD, POOL_SCAN_ESN0 = 82, 2, 0.75


def drive_pool_scan(dev: torch.device, n_ch: int = POOL_SCAN_CHANNELS,
                    rounds: int = 4) -> dict:
    """FusedDevicePool over n_ch channels of CONFIG_3 at the c3_pool_scan
    cell's traffic: a frame a channel a round at POOL_SCAN_LEAD symbols
    into a POOL_SCAN_CHUNK-symbol chunk, white noise at POOL_SCAN_ESN0 dB.
    From the second round every channel is due a frame; 9/10 of them must
    arrive, each with the bytes its channel sent. Its launch shapes (the
    noncoherent scan [C,14824]x[9,4,136], the refinement
    [3C,1088]x[3,4,136], the FIRs and the rate-4/16 decode at C rows) are
    held against the plain versions by hold_path_shapes."""
    g = build_geometry(3)
    pool = serve.FusedDevicePool(g, n_ch, rx=RxChain(g, device=dev))
    chunk, lead = POOL_SCAN_CHUNK * pool.sym_len, POOL_SCAN_LEAD * pool.sym_len
    tx = TxChain(g, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2503)
    sigma = sim.sigma_for_esn0(POOL_SCAN_ESN0)
    kernels.reset_launch_counts()
    due = delivered = 0
    ms = []
    for r in range(rounds):
        pay = torch.randint(0, 256, (n_ch, g.frame_bytes), generator=gen,
                            device=dev, dtype=torch.uint8)
        block = sigma * torch.randn((n_ch, chunk), generator=gen, device=dev)
        block[:, lead: lead + g.total_frame_size] += tx.transmit(pay)
        block = block.cpu().numpy()
        want = pay.cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pool.unpack(pool.round(block))
        ms.append((time.perf_counter() - t0) * 1e3)
        if r == 0:
            assert out == [], "the first round arms the pool"
            continue
        due += n_ch
        delivered += len(out)
        for c, res in out:
            assert bytes(res.payload[0]) == bytes(want[c]), (
                f"CONFIG_3 pool: channel {c} delivered other bytes")
    launches = dict(kernels.LAUNCHES)
    assert delivered >= due * 9 // 10, (
        f"CONFIG_3 pool: {delivered}/{due} frames delivered")
    print(f"FusedDevicePool, {n_ch} channels of CONFIG_3 at "
          f"{POOL_SCAN_ESN0} dB (c3_pool_scan's traffic): {delivered}/{due} "
          f"due frames delivered with the bytes sent over {rounds - 1} "
          f"rounds; ms a round {[round(t, 2) for t in ms]}; launches "
          f"{launches}")
    return {"launches": launches}


def drive_channel_parallel(dev: torch.device) -> dict:
    """channel_parallel_receive on virtual meshes of 1, 2 and 4 shards of
    the one card: CONFIG_9 at 12 dB, 256 channels (every row decodes its
    payload; payload, crc_ok and delay equal the unsharded receive's, iters
    within one sweep; no transfer between shards), wall times host clock
    (mean of 3 after a warm-up, each ending in a synchronize); CONFIG_0 at
    12 dB as 4 shards x 64 rows, which launches all five kernels under
    shards; then spmd_overhead_curve at a fixed total batch of 256 (white
    noise, so every row decodes through all 50 LDPC sweeps)."""
    launches = dict.fromkeys(KERNELS, 0)

    def counted(fn):
        kernels.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        for k in KERNELS:
            launches[k] += kernels.LAUNCHES[k]
        return res

    g = build_geometry(9)
    rx = RxChain(g, device=dev)
    buf, payload, _delay = make_buffer(g, dev, 12.0, 909)
    ref, walls = timed_runs(lambda: rx.receive(buf), 4)
    walls = {"unsharded": float(np.mean(walls[1:]))}
    for n in (1, 2, 4):
        mesh = shard.make_mesh(n, devices=[dev] * n)
        run = shard.channel_parallel_receive(rx, mesh)
        res, ms = timed_runs(lambda: counted(lambda: run(buf)), 4)
        walls[n] = float(np.mean(ms[1:]))
        ok = res.crc_ok
        assert bool(ok.all()) and torch.equal(res.payload, payload), (
            f"channel-parallel {n}: {int(ok.sum())}/{BATCH}")
        for f in ("payload", "crc_ok", "delay"):
            assert torch.equal(getattr(res, f), getattr(ref, f)), (n, f)
        assert (res.iters - ref.iters).abs().max().item() <= 1
        assert run.log == [] and analysis.logged_transfers(run) == {}
    print(f"channel-parallel CONFIG_9 at 12 dB, {BATCH} channels, virtual "
          f"meshes on one card: every row decoded, payload, crc_ok and "
          f"delay equal to the unsharded receive's, no transfer between "
          f"shards; wall ms (mean of 3): unsharded "
          f"{walls['unsharded']:.2f}, 1 shard {walls[1]:.2f}, 2 shards "
          f"{walls[2]:.2f}, 4 shards {walls[4]:.2f}; vs 1 shard "
          f"{walls[2] / walls[1]:.3f} (2), {walls[4] / walls[1]:.3f} (4)")
    g0 = build_geometry(0)
    rx0 = RxChain(g0, device=dev)
    buf0, payload0, _d0 = make_buffer(g0, dev, 12.0, 910)
    kernels.reset_launch_counts()
    run0 = shard.channel_parallel_receive(rx0, shard.make_mesh(
        4, devices=[dev] * 4))
    res0, ms0 = timed_runs(lambda: run0(buf0), 2)
    n0 = dict(kernels.LAUNCHES)
    for k in KERNELS:
        launches[k] += n0[k]
    assert bool(res0.crc_ok.all()) and torch.equal(res0.payload, payload0)
    assert path_ran(n0, 0, 8), n0
    print(f"channel-parallel CONFIG_0 at 12 dB, 4 shards x {BATCH // 4} rows: "
          f"{int(res0.crc_ok.sum())}/{BATCH} decoded, payloads equal; wall "
          f"{ms0[0]:.2f} then {ms0[1]:.2f} ms; launches over 2 calls {n0}")
    curve = counted(lambda: shard.spmd_overhead_curve(
        rx, (1, 2, 4), total_batch=BATCH, reps=1, device=dev))
    print("spmd_overhead_curve CONFIG_9, white noise, total batch "
          f"{BATCH}, virtual meshes on one card: " + "; ".join(
              f"{c['devices']} shards {c['wall_ms']:.2f} ms, "
              f"{c['overhead_vs_1dev']:.3f} x 1 shard" for c in curve))
    assert [c["devices"] for c in curve] == [1, 2, 4]
    return {"launches": launches, "walls": walls, "curve": curve}


def drive_time_sharded(dev: torch.device) -> dict:
    """time_sharded_receive over 4 virtual shards: CONFIG_9 at 12 dB with
    256 streams of 4 x 92480 samples, CONFIG_0 with 64 streams of
    4 x 118592 (ts_plan's frames): every frame claimed exactly once with
    its payload within 16 samples (check_claims), the dedupe dropping at
    least one right-hand decode of a seam frame, and the claims, delays and
    claimed payloads equal to plain_claims' (plain receives of each
    shard's window, uncounted). The log: 3 halos and 3 dedupe rows a
    stream batch, each halo one frame + 2 symbols of every row."""
    launches = dict.fromkeys(KERNELS, 0)
    out = {}
    for cfg, rows, esn0 in ((9, BATCH, 12.0), (0, BATCH // 4, 12.0)):
        g = build_geometry(cfg)
        rx = RxChain(g, device=dev)
        plan = ts_plan(g, rows, 4)
        stream, payloads = sharded_stream(g, dev, rows, plan, 4, esn0,
                                          cfg + 300)
        run = shard.time_sharded_receive(rx, shard.make_mesh(
            4, axis="t", devices=[dev] * 4))
        kernels.reset_launch_counts()
        res, ms = timed_runs(lambda: run(stream), 2)
        n = dict(kernels.LAUNCHES)
        for k in KERNELS:
            launches[k] += n[k]
        counts = check_claims(f"time-sharded CONFIG_{cfg}", res, plan,
                              payloads, 4)
        assert counts["dedupes"] > 0, counts
        assert path_ran(n, cfg), n
        halo = ((g.nofdm * (g.nsymb + g.preamble_nsymb) + 2 * g.nofdm)
                * g.interp)
        claim, gd, pay = plain_claims(rx, stream, 4, halo, g.nofdm * g.interp)
        assert torch.equal(res.crc_ok, claim), (
            f"CONFIG_{cfg}: claims differ from the plain receives' on "
            f"{int((res.crc_ok != claim).sum())} (shard, row)s")
        assert torch.equal(res.delay[claim], gd[claim])
        assert torch.equal(res.payload[claim], pay[claim])
        moves = analysis.logged_transfers(run)
        assert moves == {"halo": 3, "dedupe": 3}, moves
        assert {e["bytes"] for e in run.log if e["kind"] == "halo"} == {
            4 * halo * rows}
        print(f"time-sharded CONFIG_{cfg} at {esn0} dB, {rows} streams of 4 x "
              f"{stream.shape[1] // 4} samples on 4 virtual shards "
              f"(windows [{rows},{stream.shape[1] // 4 + halo}]): "
              f"{counts['claimed']}/{counts['frames']} frames claimed once, "
              f"payloads equal, within 16 samples, claims, delays and "
              f"payloads those of plain receives of each window; the dedupe "
              f"dropped {counts['dedupes']} right-hand decodes of the {rows} "
              f"seam frames; wall {ms[0]:.2f} then "
              f"{ms[1]:.2f} ms; transfers {moves}, halo {4 * halo * rows} "
              f"bytes each; launches over 2 calls {n}")
        out[cfg] = ms
    return {"launches": launches, "ms": out}


def halo_overlap(prof, n_halo: int) -> dict:
    """From a profile of time_sharded_receive_stream: the device intervals
    of its halo copies (every memcpy launched inside its mercury::halo
    ranges, linked by correlation id; there must be n_halo of them, else
    the assertion lists each one's name and us) and how much of them
    overlaps a kernel of the decodes (any non-memcpy, non-memset device
    event in the window)."""
    evs = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA

    def span(e):
        return e.start_ns(), e.start_ns() + e.duration_ns()

    ranges = [(*span(e), e.start_thread_id()) for e in evs
              if e.name() == "mercury::halo" and e.device_type() != cuda]
    corr = {e.correlation_id() for e in evs
            if e.device_type() != cuda and e.correlation_id() > 0
            and any(a <= e.start_ns() and span(e)[1] <= b and th ==
                    e.start_thread_id() for a, b, th in ranges)}
    dev_evs = [e for e in evs if e.device_type() == cuda]
    found = sorted((span(e), e.name()) for e in dev_evs
                   if e.linked_correlation_id() in corr
                   and "Memcpy" in e.name())
    assert len(found) == n_halo, (
        f"{len(found)} memcpys in the halo ranges, {n_halo} halos: "
        f"{[(name, (b - a) / 1e3) for (a, b), name in found]}")
    copies = [sp for sp, _name in found]
    busy = sorted(span(e) for e in dev_evs if "Memcpy" not in e.name()
                  and "Memset" not in e.name())
    merged = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = sum(b - a for a, b in copies)
    over = sum(max(0, min(b, mb) - max(a, ma))
               for a, b in copies for ma, mb in merged)
    return {"copies": len(copies), "copy_ns": total, "overlap_ns": over,
            "ranges": len(ranges), "halo_ns": [b - a for a, b in copies]}


def drive_stream_form(dev: torch.device) -> dict:
    """time_sharded_receive_stream, CONFIG_16 at 31 dB, 256 streams of
    K = 3 blocks over 4 virtual shards: a frame mid each even slice, one
    straddling each odd slice's right seam (the last slice's into the next
    block's first, completed from the halo of the next block's head; in the
    last block it stays inside): every frame claimed exactly once. The log
    audit: each halo of block k+1 issued before block k's decode and waited
    on after it. Timed unprofiled (host clock), then once more under the
    profiler: the halo copies' device time, bytes over it (a same-card
    copy rate, not NVLink), and the share of it under a decode's kernels;
    that rate goes into analysis.predicted_efficiency with the unsharded
    receive's measured Msamples/s."""
    g = build_geometry(16)
    n = g.nofdm * g.buffer_nsymb * g.interp
    fl = g.nofdm * (g.nsymb + g.preamble_nsymb) * g.interp
    k_blocks, n_dev = 3, 4
    plan = {}
    for r in range(BATCH):
        for k in range(k_blocks):
            for j in range(n_dev):
                sl = k * n_dev + j
                if j % 2 == 0:
                    plan[r, sl] = sl * n + 20000 + 53 * (r % 64)
                elif sl < k_blocks * n_dev - 1:
                    plan[r, sl] = (sl + 1) * n - fl // 3
                else:
                    plan[r, sl] = (sl + 1) * n - fl - 100
    stream, payloads = sharded_stream(g, dev, BATCH, plan, k_blocks * n_dev,
                                      31.0, 316)
    x = stream.reshape(BATCH, k_blocks, n_dev * n)
    rx = RxChain(g, device=dev)
    run = shard.time_sharded_receive_stream(rx, shard.make_mesh(
        n_dev, axis="t", devices=[dev] * n_dev), n_blocks=k_blocks)
    kernels.reset_launch_counts()
    res, ms = timed_runs(lambda: run(x), 2)
    launches = dict(kernels.LAUNCHES)
    counts = check_claims("stream form CONFIG_16", res, plan, payloads,
                          n_dev, k_blocks)
    rep = analysis.audit_overlap_structure(run)
    assert rep["overlap_scheduled"], rep
    assert path_ran(launches, 16), launches
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run(x)
        torch.cuda.synchronize()
    n_halo = rep["transfers"]["halo"]
    ov = halo_overlap(prof, n_halo)
    assert ov["ranges"] == n_halo, (ov, rep)
    halo_bytes = rep["halo_bytes"]
    rate = n_halo * halo_bytes / (ov["copy_ns"] * 1e-9)
    single, t1 = timed_runs(lambda: rx.receive(x[:, 0, :n]), 4)
    msps = BATCH * n / (min(t1[1:]) * 1e-3) / 1e6
    pred = analysis.predicted_efficiency(msps, g, link_bytes_per_s=rate)
    print(f"stream form CONFIG_16 at 31 dB, {BATCH} streams, K = {k_blocks} "
          f"blocks of {n_dev} x {n} on {n_dev} virtual shards: "
          f"{counts['claimed']}/{counts['frames']} frames claimed once, "
          f"payloads equal, within 16 samples; wall {ms[0]:.2f} then "
          f"{ms[1]:.2f} ms; audit {rep}; launches over 2 calls {launches}")
    print(f"stream form halo copies under the profiler: {ov['copies']} "
          f"copies of {halo_bytes} bytes, {ov['copy_ns'] / 1e3:.3f} us of "
          f"device time in all, {100 * ov['overlap_ns'] / ov['copy_ns']:.1f}% "
          f"of it under a decode's kernels (each halo copy "
          f"{min(ov['halo_ns']) / 1e3:.3f}-{max(ov['halo_ns']) / 1e3:.3f} us, "
          f"the only memcpys in the halo ranges); same-card copy rate "
          f"{rate / 1e9:.1f} GB/s (one card's memory, not NVLink); "
          f"unsharded CONFIG_16 receive {min(t1[1:]):.2f} ms = {msps:.3f} "
          f"Msamples/s; predicted_efficiency at that rate: "
          f"{json.dumps(pred)}")
    return {"launches": launches, "ms": ms, "overlap": ov, "rate": rate}


def mesh_2d_case(g, dev: torch.device) -> tuple:
    """drive_mesh_2d's streams: CONFIG_16 at 31 dB, 256 streams of 2 x
    n_local, a frame straddling the seam and one mid slice 1 on every row.
    -> (plan, stream, payloads)."""
    n = g.nofdm * g.buffer_nsymb * g.interp
    fl = g.nofdm * (g.nsymb + g.preamble_nsymb) * g.interp
    plan = {}
    for r in range(BATCH):
        plan[r, 0] = n - fl // 2
        plan[r, 1] = n + 20000 + 41 * (r % 64)
    stream, payloads = sharded_stream(g, dev, BATCH, plan, 2, 31.0, 2)
    return plan, stream, payloads


def drive_mesh_2d(dev: torch.device) -> dict:
    """A 2 x 2 (dcn, t) virtual mesh: CONFIG_16 at 31 dB, 2 groups x 128
    streams of 2 x 72896 samples (a frame mid slice 0 and one straddling
    the seam on every row): every frame claimed once, and no transfer
    between the groups."""
    g = build_geometry(16)
    n = g.nofdm * g.buffer_nsymb * g.interp
    plan, stream, payloads = mesh_2d_case(g, dev)
    mesh = shard.make_mesh_2d(2, 2, axes=("dcn", "t"), devices=[dev] * 4)
    run = shard.time_sharded_receive(RxChain(g, device=dev), mesh,
                                     time_axis="t", batch_axis="dcn")
    kernels.reset_launch_counts()
    res, ms = timed_runs(lambda: run(stream), 2)
    launches = dict(kernels.LAUNCHES)
    counts = check_claims("2-D mesh CONFIG_16", res, plan, payloads, 2)
    moves = [e for e in run.log if "bytes" in e]
    assert moves and all(e["src"].split(".")[0] == e["dst"].split(".")[0]
                         for e in moves), moves
    print(f"2 x 2 (dcn, t) virtual mesh, CONFIG_16 at 31 dB, 2 groups x "
          f"{BATCH // 2} streams of 2 x {n}: {counts['claimed']}/"
          f"{counts['frames']} frames claimed once; {len(moves)} transfers, "
          f"none between groups; wall {ms[0]:.2f} then {ms[1]:.2f} ms; "
          f"launches over 2 calls {launches}")
    return {"launches": launches}


# the multi-process forms: each as 2 ranks (scale.dist) and as the
# one-process virtual mesh of the same shape on the card
PROCESS_FORMS = ("2-D CONFIG_16", "time axis CONFIG_9",
                 "channel-parallel CONFIG_0")


def process_case(name: str, dev: torch.device) -> tuple:
    """The input of one of PROCESS_FORMS, made from its seed on the card
    alike in every process. -> (geometry, input, plan or None, payloads,
    slices a row: 2, or None for channel-parallel)."""
    if name == "2-D CONFIG_16":
        g = build_geometry(16)
        plan, stream, payloads = mesh_2d_case(g, dev)
        return g, stream, plan, payloads, 2
    if name == "time axis CONFIG_9":
        g = build_geometry(9)
        plan = ts_plan(g, BATCH, 2)
        stream, payloads = sharded_stream(g, dev, BATCH, plan, 2, 12.0, 309)
        return g, stream, plan, payloads, 2
    g = build_geometry(0)
    buf, payload, _delay = make_buffer(g, dev, 12.0, 910, batch=BATCH)
    return g, buf, None, payload, None


def process_program(name: str, g, dev: torch.device, group=None):
    """The program of one of PROCESS_FORMS: on a mesh over the group's 2
    ranks, or (group None) on the same mesh in one process, every shard on
    dev: the 2 x 2 (dcn, t) mesh with dcn across the ranks, the time axis
    across them, or the channel axis across them."""
    per_rank = 2 if group is not None else 1
    rx = RxChain(g, device=dev)
    if name == "2-D CONFIG_16":
        mesh = shard.make_mesh_2d(2, 2, axes=("dcn", "t"),
                                  devices=[dev] * (4 // per_rank),
                                  group=group)
        return shard.time_sharded_receive(rx, mesh, time_axis="t",
                                          batch_axis="dcn")
    if name == "time axis CONFIG_9":
        return shard.time_sharded_receive(rx, shard.make_mesh(
            2, axis="t", devices=[dev] * (2 // per_rank), group=group))
    return shard.channel_parallel_receive(rx, shard.make_mesh(
        2, devices=[dev] * (2 // per_rank), group=group))


def process_turns(run2, run1, x, group) -> tuple:
    """The 2-rank program run2 and, on rank 0, the one-process program run1
    on the same input, in turns (one, two, two, one, one, two) after a
    warm-up of each: each call from a barrier of the ranks to its
    synchronize and a barrier after it (rank 1 waits in the barriers while
    rank 0 runs run1). -> (run2's last result, run1's (None on rank 1),
    host ms of the 3 2-rank calls, of the 3 one-process calls)."""
    def call(run):
        torch.distributed.barrier()
        t0 = time.perf_counter()
        res = None if run is None else run(x)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        return res, (time.perf_counter() - t0) * 1e3

    res2, _ms = call(run2)
    res1, _ms = call(run1)
    walls = {run2: [], run1: []}
    for run in (run1, run2, run2, run1, run1, run2):
        res, ms = call(run)
        walls[run].append(ms)
    return res2, res1, walls[run2], walls[run1]


def rank_forms(group) -> dict:
    """A rank of drive_processes (scale.dist's rank program runs it): every
    PROCESS_FORMS form over the 2 ranks and, on rank 0 with rank 1 idle,
    the same form on one process (process_turns), the kernels' counts from
    0 just before and read just after; then one call of each 2-rank form
    under the profiler (device busy: this process's kernels), the peak
    memory, the process-to-process link rate, a rank's own CONFIG_0 shard
    alone and with the other rank's at once, rank 0's unsharded CONFIG_9
    receive of BENCH's capture, and every kernel shape launched held
    against its plain version (hold_path_shapes), the ranks in turn. ->
    the results on the host, the figures and the counts."""
    dev = group.devices[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    native.load_library()
    log = ShapeLog()
    log.path = f"processes, rank {group.rank}"
    cases = {name: process_case(name, dev) for name in PROCESS_FORMS}
    forms = {name: (process_program(name, cases[name][0], dev, group),
                    cases[name][1]) for name in PROCESS_FORMS}
    one = ({name: process_program(name, cases[name][0], dev)
            for name in PROCESS_FORMS} if group.rank == 0 else {})
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"describe": group.describe(), "forms": {}}

    def host(res):
        return {f: getattr(res, f).cpu() for f in ("crc_ok", "delay",
                                                   "payload")}

    kernels.reset_launch_counts()
    for name, (run, x) in forms.items():
        res2, res1, ms2, ms1 = process_turns(run, one.get(name), x, group)
        out["forms"][name] = {
            "res": host(res2), "one": None if res1 is None else host(res1),
            "ms": ms2, "one_ms": ms1,
            "transfers": analysis.logged_transfers(run)}
    torch.cuda.synchronize()
    out["launches"] = dict(kernels.LAUNCHES)
    for name, (run, x) in forms.items():
        torch.distributed.barrier()
        _res, busy, _wall, nccl = profile_busy(lambda: run(x))
        out["forms"][name]["busy_ms"] = busy
        out["forms"][name]["nccl_ms"] = nccl
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del one
    out["link"] = bench.link_rate(dev, bench.halo_bytes(build_geometry(9)),
                                  group=group)
    # what the ranks do to each other on a card: this rank's own shard of
    # the channel-parallel form (its 128 rows through its chain), with the
    # ranks in turn and both at once, in turns (alone, at once, at once,
    # alone)
    run, x = forms["channel-parallel CONFIG_0"]
    sh = next(s for s in run.shards if s.local)
    rows = BATCH // group.world_size
    mine = x[group.rank * rows: (group.rank + 1) * rows]

    def receive():
        with sh.on():
            return sh.rx.receive(mine)

    shared = {"alone": [], "at once": []}
    for kind in ("alone", "at once", "at once", "alone"):
        for r in range(group.world_size):
            torch.distributed.barrier()
            if kind == "at once" or r == group.rank:
                shared[kind] += timed_runs(receive, 4)[1][1:]
            if kind == "at once":
                break
    out["shared"] = {k: float(np.mean(v)) for k, v in shared.items()}
    torch.distributed.barrier()
    if group.rank == 0:
        # the unsharded receive of BENCH's capture, for the prediction
        g9 = build_geometry(9)
        rx9 = RxChain(g9, device=dev)
        buf9, _payload, _delay = bench.bench_buffer(g9, dev)
        out["t9"] = min(timed_runs(lambda: rx9.receive(buf9), 4)[1][1:])
        out["msps"] = buf9.numel() / (out["t9"] * 1e-3) / 1e6
    # the shapes held one rank at a time, so that their times are the card's
    for r in range(group.world_size):
        torch.distributed.barrier()
        if r == group.rank:
            out["held"] = len(hold_path_shapes(log))
    return out


def bench_under_torchrun() -> None:
    """`torchrun --nproc-per-node 2 -m mercury_tpu_torch.bench` as the
    README gives it (torch.distributed.run from this Python, from the
    repo's root): each rank brings up the group on its card (one card: both
    on cuda:0 over gloo), rank 0 prints BENCH's one line (every warm-up row
    decoded, link "process" at a rate > 0, no transfer in the
    channel-parallel receive, the overlap scheduled), rank 1 prints none;
    both exit 0 within 300 s, or the whole process group is killed and the
    phase fails."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "-m", "mercury_tpu_torch.bench"], cwd=dist.ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert proc.returncode == 0 and len(lines) == 1, (
        proc.returncode, out[-3000:], err[-3000:])
    rec = json.loads(lines[0])
    sc = rec["scaling"]
    assert rec["warmup_decoded"] == BATCH and rec["value"] > 0, rec
    assert rec["backend"] == "torch-cuda", rec
    assert sc["link"] == "process" and sc["link_bytes_per_s"] > 0, sc
    assert sc["channel_parallel_collective_bytes"] == 0, sc
    assert sc["time_sharded_overlap_scheduled"], sc
    groups = re.findall(r"rank \d of 2 on .+?: (?:gloo|nccl)", err)
    assert len(groups) == 2, err[-3000:]
    print(f"processes: BENCH under torchrun in "
          f"{time.perf_counter() - t0:.1f} s; " + "; ".join(sorted(groups)))
    print(lines[0])


def drive_processes(dev: torch.device) -> dict:
    """Meshes over processes (scale.dist): PROCESS_FORMS as 2 ranks started
    by the launcher on this machine's card(s) (both on one card over gloo,
    CUDA tensors through host memory; NCCL with a card a rank where there
    are two): the 2 x 2 CONFIG_16 plan of drive_mesh_2d (dcn across the
    ranks), CONFIG_9 time-sharded with the time axis across the ranks (256
    streams of 2 x 92480 at 12 dB, ts_plan's frames: its halos and dedupe
    rows cross processes), CONFIG_0 channel-parallel, 2 x 128 rows at 12
    dB (all five kernels under ranks). Each rank's result must equal the
    one-process form's on the same input (run in rank 0, rank_forms):
    crc_ok, and the payload and delay of every claim (for the time-sharded
    forms every frame claimed once, check_claims). Prints each form's wall
    (mean of 3 after a warm-up, host clock) beside the one-process form's,
    each rank's idle share and peak memory, a rank's own shard alone and at
    once with the other's, the process-to-process link rate and
    predicted_efficiency at it; the ranks hold every kernel shape they
    launched. This process only starts the ranks and checks them, so that
    both forms are timed in like processes, in turns. Then BENCH as 2
    ranks under torchrun (bench_under_torchrun)."""
    # the ranks share the card: hand them what this process has cached
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        ranks, logs = dist.run_ranks(f"{pathlib.Path(__file__).resolve()}"
                                     ":rank_forms", 2, work, timeout=600)
    t_ranks = time.perf_counter() - t0
    for r, text in enumerate(logs):
        for line in text.splitlines():
            print(f"[rank {r}] {line}")
    for name in PROCESS_FORMS:
        _g, _x, plan, payloads, n_dev = process_case(name, dev)
        ref = ranks[0]["forms"][name]["one"]
        for r, out in enumerate(ranks):
            got = out["forms"][name]["res"]
            claim = got["crc_ok"]
            assert torch.equal(claim, ref["crc_ok"]), (
                f"{name}, rank {r}: claims differ from one process's on "
                f"{int((claim != ref['crc_ok']).sum())} rows")
            for f in ("payload", "delay"):
                assert torch.equal(got[f][claim], ref[f][claim]), (name, f)
            if plan is None:
                assert bool(claim.all()) and torch.equal(
                    got["payload"], payloads.cpu()), name
            else:
                counts = check_claims(f"{name}, rank {r}",
                                      types.SimpleNamespace(**got), plan,
                                      payloads, n_dev)
        ms2 = ranks[0]["forms"][name]["ms"]
        ms1 = ranks[0]["forms"][name]["one_ms"]
        wall2, wall1 = float(np.mean(ms2)), float(np.mean(ms1))
        busy = [out["forms"][name]["busy_ms"] for out in ranks]
        nccl = [out["forms"][name]["nccl_ms"] for out in ranks]
        moves = ranks[0]["forms"][name]["transfers"]
        print(f"processes {name}: 2 ranks {wall2:.2f} ms against one "
              f"process {wall1:.2f} ms (x{wall2 / wall1:.3f}; means of 3 in "
              f"turns, 2 ranks {[round(m, 2) for m in ms2]}, one "
              f"{[round(m, 2) for m in ms1]}); device busy {busy[0]:.3f} / "
              f"{busy[1]:.3f} ms (rank 0 / 1, one call under the "
              f"profiler; NCCL's kernels apart, {nccl[0]:.3f} / "
              f"{nccl[1]:.3f} ms): idle share {1 - busy[0] / wall2:.3f} / "
              f"{1 - busy[1] / wall2:.3f}, both ranks' kernels "
              f"{sum(busy):.3f} ms of the {wall2:.2f} ms wall; every "
              f"rank's claims, payloads and delays those of one process"
              + ("" if plan is None else
                 f", {counts['claimed']}/{counts['frames']} frames claimed "
                 f"once") + f"; rank 0's transfers {moves}")
    launches = {k: sum(out["launches"][k] for out in ranks) for k in KERNELS}
    assert all(path_ran(out["launches"], cfg) for cfg in (16, 9, 0)
               for out in ranks), [out["launches"] for out in ranks]
    rate, link = ranks[0]["link"]
    msps = ranks[0]["msps"]
    pred = analysis.predicted_efficiency(msps, build_geometry(9),
                                         link_bytes_per_s=rate)
    print("processes: a rank's own CONFIG_0 shard, its "
          f"{BATCH // 2} rows (mean of 6): " + "; ".join(
              f"rank {r} alone {out['shared']['alone']:.2f} ms, both ranks "
              f"at once {out['shared']['at once']:.2f} ms"
              for r, out in enumerate(ranks)))
    print(f"processes: {ranks[0]['describe']}; ranks launched and joined "
          f"in {t_ranks:.1f} s; peak memory {ranks[0]['peak_bytes'] / 2**30:.3f}"
          f" / {ranks[1]['peak_bytes'] / 2**30:.3f} GiB (rank 0 / 1); "
          f"launches {[out['launches'] for out in ranks]}; kernel shapes "
          f"held in the ranks {ranks[0]['held']} / {ranks[1]['held']}; "
          f"link rate ({link}, rank 0 -> 1 and back, halved, median of 15) "
          f"{rate / 1e9:.4f} GB/s; rank 0's unsharded CONFIG_9 receive of "
          f"BENCH's capture {ranks[0]['t9']:.2f} ms (min of 3) = "
          f"{msps:.3f} Msamples/s; predicted_efficiency at that rate: "
          f"{json.dumps(pred)}")
    bench_under_torchrun()
    return {"launches": launches, "ranks": ranks}


def drive_ts_fir(dev: torch.device) -> None:
    """time_sharded_fir over 4 virtual shards: CONFIG_0's data taps on
    [256, 4 x 92480] white noise, within rtol 1e-5 / atol 1e-6 of the
    unsharded ops.fir_same (both cuDNN conv1d, TF32 off)."""
    g = build_geometry(0)
    taps = g.fir_rx_data.astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((BATCH, 4 * 92480), generator=gen, device=dev)
    f = shard.time_sharded_fir(shard.make_mesh(4, axis="t",
                                               devices=[dev] * 4), taps)
    got, ms = timed_runs(lambda: f(x), 3)
    want = ops.fir_same(x, torch.as_tensor(taps, device=dev))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    err = (got - want).abs().max().item()
    print(f"time_sharded_fir [{BATCH},{4 * 92480}] on 4 virtual shards: max "
          f"abs err {err:.3e} against the unsharded ops.fir_same (rtol "
          f"1e-5, atol 1e-6); {len(f.log)} halos of "
          f"{f.log[0]['bytes']} bytes; wall {ms[1]:.2f} / {ms[2]:.2f} ms")


def drive_deep_profiles(dev: torch.device) -> dict:
    """deep_profile "c2f" and "full" at CONFIG_3, 10 dB, batch 256: every
    row decodes its payload; receive times host clock."""
    g = build_geometry(3)
    buf, payload, delay = make_buffer(g, dev, 10.0, 303)
    launches = dict.fromkeys(KERNELS, 0)
    for profile in ("c2f", "full"):
        rx = RxChain(g, device=dev, deep_profile=profile)
        kernels.reset_launch_counts()
        res, ms = timed_runs(lambda: rx.receive(buf), 3)
        n = dict(kernels.LAUNCHES)
        for k in KERNELS:
            launches[k] += n[k]
        ok = res.crc_ok
        assert bool(ok.all()) and torch.equal(res.payload, payload), (
            f"CONFIG_3 {profile}: {int(ok.sum())}/{BATCH}")
        assert (res.delay - delay).abs().max().item() <= g.ngi * g.interp
        assert path_ran(n, 3), n
        # the "full" profile's 17-row scan keeps the surface
        assert profile != "full" or n["deep_mf_score"] > 0, n
        print(f"deep_profile {profile!r} CONFIG_3 at 10 dB: {BATCH}/{BATCH} "
              f"decoded, payloads equal; receive {ms[0]:.2f}, "
              f"{ms[1]:.2f}, {ms[2]:.2f} ms; launches over 3 {n}")
    return {"launches": launches}


def drive_legacy(dev: torch.device) -> None:
    """The legacy guard-interval metrics and coherent_preamble_rescore once
    each on the card, against the same call on the CPU: rtol / atol 1e-3
    for the metrics (window sums as differences of float32 prefix sums over
    the row, summed in another order on the card), rtol 1e-4 / atol 1e-5
    for the rescore (a float32 matmul at full precision on both)."""
    g = build_geometry(0)
    rx = RxChain(g, device=dev)
    buf, _payload, delay = make_buffer(g, dev, 6.0, 404)
    bb = rx.to_baseband(buf[:8], data_fir=False)            # [8, n]
    bb_ts = bb[:, ::g.interp].contiguous()
    frame = rx.extract_frame(bb, torch.full((8,), delay, device=dev))
    mf_d = 2 * g.interp
    grid, bank, _pil, _prep = rx._coherent_banks(mf_d)
    bank = bank.reshape(len(grid), g.preamble_nsymb, -1)
    cands = (delay // mf_d * mf_d + mf_d * torch.tensor(
        [-2, 0, 3, 40], device=dev))[None].expand(8, -1).contiguous()
    calls = {
        "gi_time_sync_metric": lambda b, *_: sync.gi_time_sync_metric(
            b, g, decim=g.interp, ts_nsymb=4),
        "gi_symbol_sync_metric": lambda _b, f, *_: sync.gi_symbol_sync_metric(
            f, g),
        "coherent_preamble_rescore":
            lambda b, _f, c, k: sync.coherent_preamble_rescore(
                b, c, k, 2, g.interp)}
    for name, fn in calls.items():
        got = fn(bb_ts, frame, cands, bank)
        want = fn(bb_ts.cpu(), frame.cpu(), cands.cpu(), bank.cpu())
        tol = 1e-4 if name == "coherent_preamble_rescore" else 1e-3
        torch.testing.assert_close(got.cpu(), want, rtol=tol,
                                   atol=tol / 10 if tol < 1e-3 else tol)
        print(f"{name} on the card {list(got.shape)}: max abs err "
              f"{(got.cpu() - want).abs().max().item():.3e} against the CPU")
    score = calls["coherent_preamble_rescore"](bb_ts, frame, cands, bank)
    assert (score[:, 1].argmax(-1) == len(grid) // 2).all(), score[:, 1]


def bench_latency(dev: torch.device) -> None:
    """BENCH's receive on its buffer three ways: 10 receives each between
    two synchronizes (latency, as the main paths time a receive), BENCH's
    chained rate (bench.receive_rate: no synchronize between receives)
    as ms a receive, and one receive under the profiler (device busy, from
    the table's "Self CUDA time total", against the median latency: the
    idle share)."""
    g = build_geometry(bench.CFG)
    rx = RxChain(g, device=dev)
    buf, _, _ = bench.bench_buffer(g, dev)
    rx.receive(buf)
    lat = []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rx.receive(buf + (i + 1) * 1e-7)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    chained = BATCH * buf.shape[1] / bench.receive_rate(rx, buf,
                                                        bench.REPS) * 1e3
    _res, busy, _wall, _nccl = profile_busy(lambda: rx.receive(buf))
    med = sorted(lat)[len(lat) // 2]
    print(f"BENCH's receive (CONFIG_9, batch {BATCH}, its buffer): each "
          f"between two synchronizes {min(lat):.2f} / {med:.2f} / "
          f"{max(lat):.2f} ms (min / median / max of 10); chained "
          f"(receive_rate, {bench.REPS} and {2 * bench.REPS} receives "
          f"differenced) {chained:.2f} ms a receive; one receive under the "
          f"profiler: device busy {busy:.3f} ms, idle share "
          f"{1 - busy / med:.3f} of the median")


def drive_bench_and_tools(dev: torch.device) -> dict:
    """The port's measuring entry points on the card, each as its user
    runs it: `python -m mercury_tpu_torch -m BENCH` in-process (its JSON
    line printed; every warm-up row decoded, value > 0, no transfer in the
    channel-parallel receive, the overlap scheduled), then its receive's
    latency and idle share (bench_latency); the per-mode table
    in --quick form (3 reps, no batch sweep): all 20 modes and CONFIG_0
    with deep sync off at batch 256, every row decoded; serve_bench's fused
    and device pools at 256 channels over 3 lockstep rounds, every channel
    decoded every round, beside the receive alone at batch 256; one
    adaptive link_benchmark session, CONFIG_0 at 20 dB, 2000 bytes, intact.
    Every kernel must launch."""
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["-m", "BENCH"])
    lines = out.getvalue().splitlines()
    assert rc == 0 and len(lines) == 1, (rc, lines)
    print(lines[0])
    rec = json.loads(lines[0])
    sc = rec["scaling"]
    assert rec["warmup_decoded"] == BATCH and rec["value"] > 0, rec
    assert rec["backend"] == "torch-cuda", rec
    assert sc["channel_parallel_collective_bytes"] == 0, sc
    assert sc["time_sharded_overlap_scheduled"], sc
    t_bench = time.perf_counter() - t0
    bench_latency(dev)

    t0 = time.perf_counter()
    table = throughput_table.table(dev, 3, sweep=False, log=print)
    bad = [r["config"] for r in table["per_mode"] if r["crc_ok_frac"] != 1.0]
    assert not bad, f"throughput_table: rows lost at configs {bad}"
    print(throughput_table.markdown(table))
    t_table = time.perf_counter() - t0

    t0 = time.perf_counter()
    rows = serve_bench.run(dev, [BATCH], 3, ["fused", "device"], print)
    bad = [(r["pool"], r["decoded_per_fed_frame"]) for r in rows
           if r["decoded_per_fed_frame"] != 1.0]
    assert not bad, f"serve_bench: channels lost {bad}"
    t_serve = time.perf_counter() - t0

    t0 = time.perf_counter()
    link = link_benchmark.run_session(0, 20.0, 2000, True, False, seed=200,
                                      device=dev)
    assert link["intact"] and link["delivered"] == 2000, link
    print(f"link_benchmark adaptive CONFIG_0 at 20 dB: {json.dumps(link)}")
    launches = dict(kernels.LAUNCHES)
    assert all(v > 0 for v in launches.values()), launches
    print(f"bench and tools: BENCH {t_bench:.1f} s, throughput_table "
          f"{t_table:.1f} s, serve_bench {t_serve:.1f} s, link_benchmark "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    return {"launches": launches}


def drive_qualification_tools(dev: torch.device) -> dict:
    """The qualification tools on the card at short sizes: one
    ber_campaign job (CONFIG_9 passband, scan 64 / confirm 256 frames at
    batch 128: a waterfall found within 1 dB of the documented Es/N0); one
    ber_sweep config (CONFIG_9, 256 frames at batch 256: its grid's top
    point at FER 0, which ends the sweep, and a waterfall there); the
    pattern sweep on CONFIG_100 at -2..0 dB, 64 trials a point and 64
    false-alarm trials (each pattern detected by its own detector in 95%
    of the trials or more, as the JAX record's 100%; no false alarm); one
    fading point (CONFIG_9, "good", 18 dB, 64 frames: FER <= 0.25, the JAX
    record 0.078 at 256 frames); audio_stress at 120 bytes with a noise
    burst from 4 to 120 s of the link clock (intact, a BREAK and a
    gearshift down); the roofline, every stage timed (3 launches, not
    profiled) and each share at or below its limit. Every kernel must
    launch."""
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    times = {}
    entry = ber_campaign.run_job(9, "high", HIGH_DENSITY, "passband", 128,
                                 64, 256, dev, print)
    gap = entry["gap_vs_documented_db"]
    assert gap is not None and abs(gap) <= 1.0, entry
    print(f"ber_campaign CONFIG_9 passband: waterfall "
          f"{entry['waterfall_fer10']:.3f} dB, effective "
          f"{entry['effective_waterfall_db']} dB (documented "
          f"{entry['documented_db']}), {len(entry['points'])} points")
    times["ber_campaign"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    sw = ber_sweep.sweep_config(9, BATCH, BATCH, dev)
    top = max(ber_sweep.GRIDS[9])
    assert [(p["esn0_db"], p["fer"]) for p in sw["points"]] == [(top, 0.0)], sw
    assert sw["waterfall_fer10"] == top, sw
    print(f"ber_sweep CONFIG_9: {json.dumps(sw)}")
    times["ber_sweep"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    pd = pattern_detect_sweep.sweep(100, 64, 64, 64, -2.0, 0.0, dev)
    for row in pd["detection"]:
        assert row[f"pdet_{row['tx']}"] >= 0.95, row
    assert all(v["alarms"] == 0 for v in pd["false_alarm"].values()), pd
    times["pattern_detect_sweep"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    (pt,) = fading_ber.run_config(9, "good", 64, 64, device=dev, snrs=(18,))
    assert pt["fer"] <= 0.25, pt
    print(f"fading_ber CONFIG_9 good 18 dB: {json.dumps(pt)}")
    times["fading_ber"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    st = audio_stress.stress(120, burst=(4.0, 120.0), device=dev, echo=False)
    print(f"audio_stress 120 bytes, burst 4-120 s: "
          f"{json.dumps(st['summary'])}; analyzer counts "
          f"{st['analyzer']['counts']}")
    assert audio_stress.passed(st["summary"]), st["summary"]
    times["audio_stress"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    rec = roofline.run(dev, reps=3, profile=False)
    assert len(rec["stages"]) == 18, rec["stages"]
    assert all(rec["receive"][k]["decoded"] == BATCH
               for k in ("CONFIG_9", "CONFIG_3", "CONFIG_0", "timed")), rec
    times["roofline"] = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    assert all(v > 0 for v in launches.values()), launches
    print("qualification tools: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in times.items())
        + f"; launches {launches}")
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
    mf_score, mf_best = check_deep_mf_score(rx3, gen, refine_only,
                                            chains["CONFIG_9"])
    stats = {"mix_fir_decimate": check_mix_fir_decimate(
                 chains, gen, PatternSignaler(build_geometry(0), device=dev),
                 {"CONFIG_0": rx0, "CONFIG_9": chains["CONFIG_9"]}),
             "deep_mf_score": mf_score, "deep_mf_best": mf_best,
             "deep_mf_max": check_deep_mf_max(rx0, gen),
             "pilot_cand_score": check_pilot_cand_score(rx0, gen),
             "ldpc_layered": check_ldpc_layered(dev)}
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
         "pilot_cand_score", "ldpc_layered"))
    run("link ROBUST", drive_link,
        dev, "ROBUST from CONFIG_100, -5 dB channel SNR",
        ArqConfig(init_configuration=100, gear_shift_on=True,
                  robust_enabled=True, batch_size=5), -5.0, 200,
        ("mix_fir_decimate", "ldpc_layered"))
    run("tcp", drive_tcp, dev)
    run("pools", drive_pools, dev)
    run("CONFIG_3 pool", drive_pool_scan, dev)
    print(f"link, tcp and pool phases: {time.perf_counter() - t_new:.1f} s")
    # multi-device receive on virtual meshes of the one card, the deep
    # profiles and the legacy metrics
    t_new = time.perf_counter()
    run("channel-parallel", drive_channel_parallel, dev)
    run("time-sharded", drive_time_sharded, dev)
    run("stream form", drive_stream_form, dev)
    run("2-D mesh", drive_mesh_2d, dev)
    t_proc = time.perf_counter()
    run("processes", drive_processes, dev)
    print(f"processes phase: {time.perf_counter() - t_proc:.1f} s")
    run("deep profiles", drive_deep_profiles, dev)
    log.path = "sharded FIR and legacy metrics"
    drive_ts_fir(dev)
    drive_legacy(dev)
    print(f"sharded receive, deep profile and legacy phases: "
          f"{time.perf_counter() - t_new:.1f} s")
    # the measuring entry points: BENCH and the three tools
    t_new = time.perf_counter()
    run("bench and tools", drive_bench_and_tools, dev)
    print(f"bench and tool phases: {time.perf_counter() - t_new:.1f} s")
    # the qualification tools: campaign, pattern sweep, fading, audio
    # stress, roofline
    t_new = time.perf_counter()
    run("qualification tools", drive_qualification_tools, dev)
    print(f"qualification tool phase: {time.perf_counter() - t_new:.1f} s")
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
