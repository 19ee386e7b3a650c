"""mercury_tpu_torch.tools (throughput_table, serve_bench, link_benchmark)
on the CPU, against the repo root's tools where they can be compared.

A seeded link_benchmark session of the port equals the JAX tool's (loaded
by path) in delivered bytes, integrity, simulated time, final config,
BREAKs and gearshifts. throughput_table.measure at batch 2 decodes every
row of every mode (and CONFIG_0 with deep sync off); the serve_bench pools
at 4 channels over 2 lockstep rounds decode every channel every round.
Without a card and without --cpu every tool exits non-zero."""

import importlib.util
import pathlib

import pytest
import torch

from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.tools import link_benchmark, serve_bench
from mercury_tpu_torch.tools import throughput_table

REPO = pathlib.Path(__file__).resolve().parent.parent
LINK_KEYS = ("delivered", "intact", "sim_seconds", "final_config", "breaks",
             "gearshift_ups")


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


def test_link_session_matches_jax():
    """CONFIG_9 at 20 dB, 500 bytes, fixed config (the tool's sweep form),
    seed 0: the JAX tool's numbers on the same arguments."""
    args = (9, 20.0, 500, False, False)
    ours = link_benchmark.run_session(*args, seed=0, device="cpu")
    theirs = _root_tool("link_benchmark").run_session(*args, seed=0)
    assert ours["intact"] and ours["delivered"] == 500
    assert {k: ours[k] for k in LINK_KEYS} == {k: theirs[k]
                                               for k in LINK_KEYS}
    assert set(ours) == set(theirs)


@pytest.mark.parametrize("config,deep_sync",
                         [(c, None) for c in throughput_table.MODES]
                         + [(0, False)])
def test_measure_decodes_every_row(config, deep_sync):
    r = throughput_table.measure(config, 2, 1, deep_sync=deep_sync,
                                 device="cpu")
    assert r["crc_ok_frac"] == 1.0, r
    assert r["config"] == config and r["batch"] == 2
    assert r["msamples_per_s"] > 0 and r["first_call_s"] > 0
    if deep_sync is False:
        assert r["deep_sync"] is False


def test_table_markdown_has_a_row_a_mode():
    out = {"per_mode": [{"config": c, "deep_sync": c == 0,
                         "msamples_per_s": 1.0, "decode_goodput_mbit_s": 0.5,
                         "realtime_channels": 20, "ms_per_call": 3.0,
                         "crc_ok_frac": 1.0} for c in (0, 9, 100)]
           + [{"config": 0, "deep_sync": False, "msamples_per_s": 2.0,
               "decode_goodput_mbit_s": 0.5, "realtime_channels": 41,
               "ms_per_call": 1.5, "crc_ok_frac": 1.0}],
           "batch_sweep": []}
    lines = throughput_table.markdown(out).splitlines()
    assert [ln.split("|")[1].strip() for ln in lines[2:]] == [
        "CONFIG_0", "CONFIG_9", "ROBUST_0", "CONFIG_0 (deep_sync=off)"]


@pytest.mark.parametrize("kind", ["fused", "device", "host"])
def test_pools_decode_every_channel(kind):
    rows = serve_bench.run("cpu", [4], 2, [kind], lambda m: None)
    assert len(rows) == 1
    row = rows[0]
    assert row["pool"] == kind and row["n_channels"] == 4
    assert row["decoded_per_fed_frame"] == 1.0, row
    assert row["kernel_msamples_per_s"] > 0 and row["pool_vs_kernel"] > 0
    if kind == "fused":
        assert row["budget"]["dispatches_per_round"] == 1
        # one packed row a channel, the chunk uploaded as float32
        g = build_geometry(serve_bench.CFG)
        assert row["budget"]["d2h_bytes"] == 4 * (g.frame_bytes + 21)
        assert row["budget"]["h2d_bytes"] == (
            4 * 4 * row["chunk_samples_per_channel"])


@pytest.mark.parametrize("main", [
    lambda: throughput_table.main(["--quick"]),
    lambda: serve_bench.main(["--channels", "4", "--rounds", "1"]),
    lambda: link_benchmark.main(["sweep", "--snrs", "20"])],
    ids=["throughput_table", "serve_bench", "link_benchmark"])
def test_no_card_without_cpu_flag_exits_nonzero(main, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    assert main() != 0
    assert "device='cpu'" in capsys.readouterr().err
