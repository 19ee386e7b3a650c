"""The port's qualification tools (mercury_tpu_torch.tools: ber_campaign,
ber_sweep, pattern_detect_sweep, fading_ber, audio_stress, roofline,
analyze_link_log) on the CPU, against the repo root's tools loaded by path.

find_waterfall searches scripted FER curves to the JAX search's points and
waterfall; a campaign job finds a waterfall, keeps the JAX record's keys
and is skipped when rerun; the pattern sweep scores the JAX tool's numpy
buffers to its detection rates, metrics and false alarms; the fading tool
fades the JAX tool's frames to the same samples and both decode the top
point; the roofline's counts are the JAX tools' formulas wherever both
count the same work; the log analyzer is a copy and parses an audio-path
session as the root's does. Without a card and without --cpu every device
tool exits non-zero."""

import importlib.util
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from mercury_tpu_torch import bench
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.fec.tables import load_code
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain
from mercury_tpu_torch.tools import analyze_link_log, audio_stress
from mercury_tpu_torch.tools import ber_campaign, ber_sweep, fading_ber
from mercury_tpu_torch.tools import pattern_detect_sweep, roofline

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the LDPC's small CPU tensors run far slower with
    MKL's threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _root_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_root_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# ber_campaign
# ---------------------------------------------------------------------------

class _Point:
    def __init__(self, e, frames, fer):
        self.esn0_db, self.frames, self.fer = e, frames, fer


def _curve(scan_at: float, confirm_at: float):
    """A scripted run_fn: FER 0.05 at and above scan_at with the scan's
    frames, else 0.5; 0.08 at and above confirm_at with the confirmation's
    frames, else 0.3."""
    def run_fn(e, n):
        if n == 4:
            return _Point(e, n, 0.05 if e >= scan_at - 1e-9 else 0.5)
        return _Point(e, n, 0.08 if e >= confirm_at - 1e-9 else 0.3)
    return run_fn


@pytest.mark.parametrize("scan_at,confirm_at", [
    (1.0, 0.75),      # found at once: the half-step below confirms
    (1.0, 2.0),       # found after two more confirmations above the scan
    (1.0, -1.25),     # refined down six half-steps
    (99.0, 0.0)],     # none: the scan never dips below 0.07
    ids=["at_once", "after_confirmations", "refined_down", "none"])
def test_find_waterfall_matches_jax(scan_at, confirm_at):
    theirs = _root_tool("ber_campaign")
    got = ber_campaign.find_waterfall(_curve(scan_at, confirm_at), -2.0, 0.5,
                                      4, 8, 6.0, lambda m: None)
    want = theirs.find_waterfall(_curve(scan_at, confirm_at), -2.0, 0.5,
                                 4, 8, 6.0, lambda m: None)
    assert got[1] == want[1]
    assert [(p.esn0_db, p.frames, p.fer) for p in got[0]] == [
        (p.esn0_db, p.frames, p.fer) for p in want[0]]
    assert (got[1] is None) == (scan_at > 50)


def test_job_list_is_the_jax_tools():
    """The JAX tool's job list, in its order, for every harness."""
    want = []
    for d in ("high", "low"):
        want += [(c, d, "baseband") for c in range(17)]
    for d in ("high", "low"):
        want += [(c, d, "passband") for c in range(17)]
    for c in (100, 101, 102):
        want += [(c, "high", "mfsk"), (c, "high", "mfsk_fixed")]
    for c in (100, 101):
        want += [(c, "high", "ctrl"), (c, "high", "ctrl_fixed")]
    assert [(c, d, h) for c, d, _, h in ber_campaign.jobs()] == want
    assert ([j[0] for j in ber_campaign.jobs("pb", "high", [0, 16])]
            == [0, 16])


def test_campaign_job_finds_a_waterfall_and_resumes(tmp_path, monkeypatch):
    out = tmp_path / "campaign.json"
    rec = ber_campaign.campaign(str(out), ber_campaign.jobs("bb", "high", [9]),
                                4, 4, 8, torch.device("cpu"), lambda m: None)
    (entry,) = rec["results"]
    assert entry["waterfall_fer10"] is not None
    assert entry["gap_vs_documented_db"] is not None
    record = json.loads((REPO / "docs" / "ber_r4b.json").read_text())
    assert set(entry) == set(record["results"][0])
    assert rec["meta"]["backend"] == "torch-cpu"
    assert json.loads(out.read_text()) == rec

    def ran(*a, **kw):
        raise AssertionError("a finished triple ran again")
    monkeypatch.setattr(ber_campaign, "run_job", ran)
    again = ber_campaign.campaign(str(out), ber_campaign.jobs("bb", "high",
                                                              [9]),
                                  4, 4, 8, torch.device("cpu"),
                                  lambda m: None)
    assert again == rec


def test_compare_flags_more_than_a_half_step():
    """compare: the later record replaces an earlier one's entry; a port
    waterfall more than 0.25 dB above the record's is flagged, 0.25 is
    not."""
    def rec(*rows):
        return {"results": [{"config": c, "density": "high",
                             "harness": "passband", "documented_db": -10.0,
                             "effective_waterfall_db": e} for c, e in rows]}
    ours = rec((0, -9.5), (1, -7.25), (2, None))
    rows = ber_campaign.compare(ours, [rec((0, -10.0), (1, -7.5)),
                                       rec((0, -9.75))])
    assert [(r["config"], r["jax"], r["diff"], r["worse"]) for r in rows] == [
        (0, -9.75, 0.25, False), (1, -7.5, 0.25, False),
        (2, None, None, False)]
    rows = ber_campaign.compare(rec((0, -9.25)), [rec((0, -9.75))])
    assert rows[0]["diff"] == 0.5 and rows[0]["worse"]


def test_ber_sweep_entry_has_the_jax_keys(monkeypatch):
    monkeypatch.setitem(ber_sweep.GRIDS, 9, [12])
    got = ber_sweep.sweep_config(9, 2, 2, "cpu")
    assert set(got) == {"points", "waterfall_fer10"}
    (p,) = got["points"]
    assert set(p) == {"esn0_db", "fer", "ber", "frames"}
    assert p["frames"] == 2 and p["fer"] == 0.0 and got["waterfall_fer10"] == 12


# ---------------------------------------------------------------------------
# pattern_detect_sweep
# ---------------------------------------------------------------------------

def test_pattern_sweep_matches_jax(tmp_path, monkeypatch):
    """The same default_rng(7) buffers through both detectors: the
    detection rates and false alarms equal, the metrics' mean, min and max
    within 1e-3."""
    out = tmp_path / "pd.json"
    monkeypatch.setattr(sys, "argv", [
        "pattern_detect_sweep.py", "--out", str(out), "--trials", "8",
        "--fa-trials", "16", "--batch", "8", "--snr-lo", "-2",
        "--snr-hi", "0"])
    assert _root_tool("pattern_detect_sweep").main() == 0
    theirs = json.loads(out.read_text())
    ours = pattern_detect_sweep.sweep(100, 8, 16, 8, -2.0, 0.0, "cpu")
    assert len(ours["detection"]) == len(theirs["detection"]) == 6
    for a, b in zip(ours["detection"], theirs["detection"]):
        assert set(a) == set(b)
        assert (a["tx"], a["snr_db"]) == (b["tx"], b["snr_db"])
        for k in a:
            if k.startswith("pdet_"):
                assert a[k] == b[k], (k, a, b)
            elif k.startswith("metric_"):
                # both tools round to thousandths: within 1e-3 is within
                # one unit of the last digit
                assert all(abs(round(x * 1000) - round(y * 1000)) <= 1
                           for x, y in zip(a[k], b[k])), (k, a[k], b[k])
    for d in ("ack", "break"):
        for k in ("alarms", "alarms_gated", "trials"):
            assert ours["false_alarm"][d][k] == theirs["false_alarm"][d][k]
    assert ours["meta"]["threshold"] == theirs["meta"]["threshold"]


# ---------------------------------------------------------------------------
# fading_ber
# ---------------------------------------------------------------------------

def test_fading_frames_match_jax():
    """A round's payloads and faded frames, drawn from the JAX tool's rng
    in its order, equal the JAX package's before noise (within 1e-5 of the
    frame's peak: the two transmitters' float32 passband)."""
    from mercury_tpu.channel import sim as jsim
    from mercury_tpu.modem.tx import TxChain as JTxChain

    g = build_geometry(9)
    seed = 100000 + 1000 * 9 + 18 * 7
    payload, pb, faded = fading_ber.faded_round(
        TxChain(g, device="cpu"), g, np.random.default_rng(seed), 2, "good")
    rng = np.random.default_rng(seed)
    want_payload = rng.integers(0, 256, (2, g.frame_bytes)).astype(np.uint8)
    want_pb = np.asarray(JTxChain(g).transmit(want_payload), np.float64)
    want = jsim.watterson(want_pb, fs=g.fs, seed=int(rng.integers(1 << 30)),
                          **jsim.WATTERSON_PRESETS["good"])
    assert np.array_equal(payload, want_payload)
    np.testing.assert_allclose(faded, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_fading_top_point_decodes_in_both(monkeypatch):
    """CONFIG_9, "good", 18 dB: both tools decode 2 of 2 frames."""
    theirs = _root_tool("fading_ber")
    monkeypatch.setattr(theirs, "SNR_GRID", {9: (18,)})
    (want,) = theirs.run_config(9, "good", 2, 2)
    (got,) = fading_ber.run_config(9, "good", 2, 2, device="cpu",
                                   snrs=(18,))
    assert got == want == {"snr_db": 18.0, "fer": 0.0, "frames": 2}


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def counts():
    rec = roofline.counts_only(torch.device("cpu"))
    return {s["stage"]: s for s in rec["stages"]}


def test_roofline_counts_are_the_jax_formulas(counts):
    """CONFIG_9, batch 256. The demod and the estimate count as the JAX
    tools do (roofline.py:127-142, roofline_k.py:176-192). The FIRs: the
    JAX FIR flops (2*2*ntaps*n_out*B), plus the mixer's 2 a sample read;
    the TS FIR's bytes are the JAX tool's plus the oscillator table
    (8 B a sample) and the taps that the port's kernel reads. The LDPC
    stages: the JAX tools' operations an edge (24 SPA, 10 min-sum,
    roofline.py:190; 30 a flooding sweep, roofline_k.py:220); their bytes
    are the function's (messages and posteriors once each), where the JAX
    tools count their implementation's gathers."""
    b = 256
    g = build_geometry(9)
    n = g.nofdm * g.buffer_nsymb * g.interp
    nt, nd = len(g.fir_rx_ts), len(g.fir_rx_data)
    n_out = n // g.interp
    ts = counts["TS FIR"]
    assert ts["flops"] - 2 * b * n == 2 * 2 * nt * n_out * b
    assert ts["bytes"] - 8 * n - 4 * nt == 4 * b * (n + 2 * n_out)
    n_data = g.nofdm * (g.nsymb + g.preamble_nsymb)
    window = (n_data - 1) * g.interp + nd
    assert (counts["data FIR"]["flops"] - 2 * b * window
            == 2 * 2 * nd * n_data * b)
    demod = counts["OFDM demod"]
    assert demod["flops"] == b * g.nsymb * 5 * g.nfft * np.log2(g.nfft)
    assert demod["bytes"] == 8 * b * g.nsymb * (g.nofdm + g.nc)
    cells, n_pil = np.asarray(g.est_op).shape
    est = counts["channel estimate"]
    assert est["flops"] == 2 * 2 * b * g.n_pilots * cells
    assert est["bytes"] == 4 * (g.n_pilots * cells
                                + b * (2 * g.n_pilots + 2 * cells))
    code = load_code(g.spec.ldpc_rate_num)
    edges = int((np.asarray(code.c_idx) >= 0).sum())
    for stage, per_edge in (("LDPC layered sweep (spa)", 24),
                            ("LDPC layered sweep (minsum)", 10),
                            ("LDPC whole decode (spa)", 24),
                            ("LDPC flooding sweep", 30)):
        assert counts[stage]["flops"] == per_edge * edges * b, stage
    for st in counts.values():
        bd = roofline.bound(st["bytes"], st["flops"], st["flop_kind"])
        assert math.isclose(bd["bound_ms"], st["bound_ms"])


def test_roofline_kernel_counts_match_perf_table(counts):
    """The four kernels' bounds (chip_smoke.py's counts, now the tool's):
    the CONFIG_3 scan and CONFIG_0's coherent scan as PERF.md's table."""
    assert counts["CONFIG_3 scan"]["bound_ms"] == pytest.approx(0.2893,
                                                                abs=1e-4)
    assert counts["CONFIG_0 coherent scan"]["bound_ms"] == pytest.approx(
        1.9607, abs=1e-4)
    assert counts["TS FIR"]["bound_ms"] == pytest.approx(0.0426, abs=1e-4)


@pytest.mark.parametrize("cfg, scan, refine", [(3, 1, 1), (9, 0, 1)])
def test_roofline_counting_tells_the_scan_from_refines(cfg, scan, refine):
    """counting() keys deep_mf_score's calls by window: a CONFIG_3 receive
    makes one whole-buffer scan and one refine, a CONFIG_9 receive (no
    deep sync) one refine; the scan stage reads the scan's key."""
    g = build_geometry(cfg)
    rx = RxChain(g, device="cpu")
    buf, _, _ = bench.make_buffer(g, "cpu", 12.0, 0, batch=2)
    with roofline.counting(rx) as calls:
        res = rx.receive(buf)
    assert bool(res.crc_ok.all())
    assert (calls["scan"], calls["refine"]) == (scan, refine)
    (st,) = [s for s in roofline.stages("cpu") if s.name == "CONFIG_3 scan"]
    assert st.receive == ("CONFIG_3", "scan")


def test_roofline_timing_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.run(torch.device("cpu"))


# ---------------------------------------------------------------------------
# analyze_link_log and audio_stress
# ---------------------------------------------------------------------------

# the port's lines that differ from the root's (the usage text)
_ANALYZER_LINES = (
    [5, 15, 16],
    ["Parses timestamped node-event lines as emitted by `python -m "
     "mercury_tpu -m",
     "Usage: python tools/analyze_link_log.py session.log [--json "
     "out.json]",
     "       ... | python tools/analyze_link_log.py -"])


def test_analyzer_is_a_copy():
    ours = pathlib.Path(analyze_link_log.__file__).read_text().splitlines()
    theirs = (REPO / "tools" / "analyze_link_log.py").read_text().splitlines()
    idx, masked = _ANALYZER_LINES
    assert [theirs[i] for i in idx] == masked
    assert len(ours) == len(theirs)
    assert ([ln for i, ln in enumerate(ours) if i not in idx]
            == [ln for i, ln in enumerate(theirs) if i not in idx])


def test_audio_session_parses_as_the_root_analyzer():
    """A clean 60-byte session through the audio engine on the CPU: intact,
    and its event lines parsed by the root analyzer give the report the
    port's gave."""
    out = audio_stress.stress(60, burst=(1e6, 1e6 + 1.0), device="cpu",
                              echo=False)
    assert out["summary"]["intact"] and out["summary"]["delivered"] == 60
    assert not audio_stress.passed(out["summary"])     # no BREAK: no burst
    an = _root_tool("analyze_link_log")
    assert out["analyzer"] == an.analyze(an.parse_lines(out["events"]))
    assert out["analyzer"]["counts"].get("CONNECTED", 0) >= 1


# ---------------------------------------------------------------------------
# no card, no --cpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool,argv", [
    (ber_sweep, ["out.json", "--configs", "9"]),
    (ber_campaign, ["--out", "out.json", "--configs", "9"]),
    (pattern_detect_sweep, ["--out", "out.json"]),
    (fading_ber, ["--out", "out.json", "--configs", "9"]),
    (audio_stress, ["--out", "out.json"]),
    (roofline, ["--out", "out.json"])],
    ids=["ber_sweep", "ber_campaign", "pattern_detect_sweep", "fading_ber",
         "audio_stress", "roofline"])
def test_no_card_without_cpu_flag_exits_nonzero(tool, argv, capsys,
                                                tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    monkeypatch.chdir(tmp_path)
    assert tool.main(argv) != 0
    assert "device='cpu'" in capsys.readouterr().err
    assert not (tmp_path / "out.json").exists()
