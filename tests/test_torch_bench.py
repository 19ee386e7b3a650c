"""mercury_tpu_torch.bench (the port's headline benchmark and the CLI's
BENCH mode) against the repo root's bench.py, on the CPU.

bench.py is loaded by path and read, never run: its constants, the
delay and buffer-length formulas of its worker (evaluated on a geometry
from the worker's own source) and the keys of its JSON line. The slice as
a whole: one CONFIG_9 bench buffer at batch 4, made by the port, through
the JAX RxChain and the port's on the same numpy samples (payload, crc_ok
and delay equal, iters within +-1: ROADMAP §3). The JSON line of
`bench.main(["--cpu"])` at batch 4 and 1 rep, the predicted efficiencies
against the JAX function at stated link rates, and the overlap audit on a
CPU virtual mesh of 2 against the analytic halo (its JAX account)."""

import ast
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry as jax_geometry
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu.scale import analysis as janalysis
from mercury_tpu_torch import __main__ as cli
from mercury_tpu_torch import bench
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.scale import analysis

REPO = pathlib.Path(__file__).resolve().parent.parent
ROOT_BENCH = REPO / "bench.py"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the LDPC's small CPU tensors run far slower with
    MKL's threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def root_bench():
    spec = importlib.util.spec_from_file_location("_root_bench", ROOT_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)        # top level: constants, no JAX
    return mod


def _function(name: str) -> ast.FunctionDef:
    tree = ast.parse(ROOT_BENCH.read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _root_formula(name: str, g) -> int:
    """The value root bench.py's worker assigns to `name`, its expression
    evaluated with the worker's g."""
    node = next(n for n in ast.walk(_function("worker"))
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == name)
    return eval(compile(ast.Expression(node.value), str(ROOT_BENCH), "eval"),
                {"g": g})


def _root_keys() -> tuple[set, set]:
    """(top-level keys, "scaling" keys) of root bench.py's JSON line: the
    worker's dict literal and the scaling keys main() adds."""
    top, scaling = set(), set()
    for node in ast.walk(_function("worker")):
        if isinstance(node, ast.Dict) and any(
                getattr(k, "value", None) == "metric" for k in node.keys):
            for k, v in zip(node.keys, node.values):
                top.add(k.value)
                if k.value == "scaling":
                    scaling |= {kk.value for kk in v.keys}
    for node in ast.walk(_function("main")):
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Subscript)
                and getattr(node.value.slice, "value", None) == "scaling"):
            scaling.add(node.slice.value)
    return top, scaling


def test_constants_and_formulas_match_root_bench(root_bench):
    assert (bench.CFG, bench.BATCH, bench.REPS) == (
        root_bench.CFG, root_bench.BATCH, root_bench.REPS)
    assert (bench.REFERENCE_CPU_SAMPLES_PER_S
            == root_bench.REFERENCE_CPU_SAMPLES_PER_S)
    g = build_geometry(bench.CFG)
    buf, payload, delay = bench.make_buffer(g, "cpu", 12.0, 1, batch=1)
    assert delay == _root_formula("delay", g)
    assert buf.shape == (1, _root_formula("buf_len", g))
    assert payload.shape == (1, g.frame_bytes)


def test_make_buffer_sends_given_payload():
    """With a payload the generator draws only the noise: the same seed
    gives the same noise whatever the payload, and the payload is sent."""
    g = build_geometry(bench.CFG)
    zero = np.zeros((2, g.frame_bytes), np.uint8)
    one = np.full((2, g.frame_bytes), 7, np.uint8)
    b0, p0, _ = bench.make_buffer(g, "cpu", 12.0, 5, batch=2, payload=zero)
    b1, p1, d = bench.make_buffer(g, "cpu", 12.0, 5, batch=2, payload=one)
    assert torch.equal(p0, torch.as_tensor(zero))
    assert torch.equal(p1, torch.as_tensor(one))
    assert torch.equal(b0[:, :d], b1[:, :d])        # noise only before it
    assert not torch.equal(b0, b1)
    res = RxChain(g, device="cpu").receive(b1)
    assert bool(res.crc_ok.all()) and torch.equal(res.payload, p1)


def test_slice_matches_jax():
    """The bench buffer (default_rng(0) payloads, 12 dB) at batch 4 through
    both packages' CONFIG_9 receive on the same samples."""
    g = build_geometry(bench.CFG)
    buf, payload, delay = bench.bench_buffer(g, "cpu", batch=4)
    np.testing.assert_array_equal(
        payload.numpy(), np.random.default_rng(0).integers(
            0, 256, (4, g.frame_bytes)).astype(np.uint8))
    x = buf.numpy()
    ours = RxChain(g, device="cpu").receive(torch.from_numpy(x))
    theirs = JaxRx(jax_geometry(bench.CFG)).receive(jnp.asarray(x))
    assert bool(ours.crc_ok.all())
    np.testing.assert_array_equal(ours.payload.numpy(), payload.numpy())
    np.testing.assert_array_equal(ours.payload.numpy(),
                                  np.asarray(theirs.payload))
    np.testing.assert_array_equal(ours.crc_ok.numpy(),
                                  np.asarray(theirs.crc_ok))
    np.testing.assert_array_equal(ours.delay.numpy(),
                                  np.asarray(theirs.delay))
    assert np.abs(ours.iters.numpy().astype(int)
                  - np.asarray(theirs.iters).astype(int)).max() <= 1
    assert (np.abs(ours.delay.numpy() - delay) <= g.ngi * g.interp).all()


def test_json_line(capsys):
    """One JSON line with root bench.py's keys, "_dcn" -> "_measured_link"
    and "_overlap_compiled" -> "_overlap_scheduled", plus backend, device,
    the warm-up count and the measured link beside the efficiencies."""
    assert bench.main(["--cpu"], batch=4, reps=1) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    top, scaling = _root_keys()
    assert set(rec) == top | {"backend", "device", "warmup_decoded"}
    assert set(rec["scaling"]) == {
        k.replace("_dcn", "_measured_link").replace(
            "_overlap_compiled", "_overlap_scheduled")
        for k in scaling} | {"link_bytes_per_s", "link"}
    assert rec["metric"] == "rx_demod_ldpc_samples_per_sec_per_chip"
    assert rec["unit"] == "Msamples/s" and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(
        rec["value"] * 1e6 / bench.REFERENCE_CPU_SAMPLES_PER_S)
    assert (rec["platform"], rec["backend"], rec["device"]) == (
        "cpu", "torch-cpu", "cpu")
    assert rec["warmup_decoded"] == 4
    sc = rec["scaling"]
    assert sc["channel_parallel_collective_bytes"] == 0
    assert sc["channel_parallel_2host_efficiency"] == 1.0
    assert sc["time_sharded_overlap_scheduled"] is True
    assert sc["link"] == "host memory" and sc["link_bytes_per_s"] > 0
    g = build_geometry(bench.CFG)
    jacc = janalysis.collective_account(jax_geometry(bench.CFG))
    assert (sc["time_sharded_halo_bytes_per_block"]
            == jacc["time_sharded_rx"]["halo_bytes_per_shard_block"])
    want = analysis.predicted_efficiency(
        rec["value"], g, link_bytes_per_s=sc["link_bytes_per_s"])
    assert (sc["time_sharded_2host_eff_serialized_measured_link"]
            == want["time_sharded_rx"]["efficiency_serialized"])
    assert (sc["time_sharded_2host_eff_overlapped_measured_link"]
            == want["time_sharded_rx"]["efficiency_overlapped"])


@pytest.mark.parametrize("rate", [1e6, 12.5e9, 400e9])
def test_predicted_efficiency_matches_jax(rate):
    """At a stated link rate the port's prediction is the JAX function's
    (a slow link where the halo outlasts the compute, and fast ones)."""
    for msps in (1.5, 800.0):
        ours = analysis.predicted_efficiency(msps, build_geometry(9),
                                             link_bytes_per_s=rate)
        theirs = janalysis.predicted_efficiency(msps, jax_geometry(9),
                                                link_bytes_per_s=rate)
        assert ours == theirs


def test_audit_on_cpu_mesh():
    """bench.audit on a virtual CPU mesh of 2: the overlap is scheduled,
    and the largest halo is one row's analytic halo (one frame + 2
    symbols of float32; the account's halo less the 8 dedupe bytes), the
    JAX account's for CONFIG_16."""
    rep = bench.audit("cpu")
    assert rep["overlap_scheduled"] is True, rep
    assert not rep["blocking_upstream"] and not rep["blocking_downstream"]
    assert rep["transfers"] == {"halo": 3, "dedupe": 3}
    g = build_geometry(16, with_pre_eq=False)
    halo = (g.nofdm * (g.nsymb + g.preamble_nsymb) * g.interp
            + 2 * g.nofdm * g.interp)
    assert rep["halo_bytes"] == 1 * halo * 4
    jacc = janalysis.collective_account(jax_geometry(16, with_pre_eq=False))
    assert (halo * 4
            == jacc["time_sharded_rx"]["halo_bytes_per_shard_block"] - 8)


@pytest.fixture
def no_ini(tmp_path, monkeypatch):
    """Run from an empty directory with an empty HOME, so the CLI finds no
    INI file."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))


def test_cli_bench_mode_passes_cpu_through(no_ini, monkeypatch):
    calls = []
    monkeypatch.setattr(bench, "main", lambda argv: calls.append(argv) or 0)
    assert cli.main(["-m", "BENCH", "--cpu"]) == 0
    assert calls == [["--cpu"]]


@pytest.mark.parametrize("run", [lambda: bench.main([]),
                                 lambda: cli.main(["-m", "BENCH"])],
                         ids=["bench.main", "cli BENCH"])
def test_no_card_without_cpu_flag_exits_nonzero(run, no_ini, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    assert run() != 0
    assert "device='cpu'" in capsys.readouterr().err
