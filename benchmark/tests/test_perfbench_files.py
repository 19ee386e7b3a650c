"""BENCHMARK.json against the rules of its format, and every cell,
configuration and metric found as a file by its name; a cell added by
files alone runs (CPU, plain versions)."""

import json
import re
import shutil
import time

import pytest
import torch

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files(cell):
    c = harness.load_cell(cell)
    assert c["chips"] == 1 and c["mode"]["name"] == c["config"]
    assert len(c["why"]) <= 200
    for trace in (False, True):
        metrics = harness.cell_metrics(trace)
        assert metrics, "a cell reports end-to-end and per-layer metrics"
        for m in metrics:
            assert callable(harness.reader(m["name"]))
    assert "setup_s" in {m["name"] for m in harness.cell_metrics(False)}
    assert set(c["limits"]) == {"missed_share", "wrong_share"}


def test_configs_used_and_files():
    used = {w["config"] for w in SPEC["workloads"]}
    for cfg in SPEC["configs"]:
        assert cfg["name"] in used
        data = json.loads((harness.ROOT / cfg["file"]).read_text())
        assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
        for key in cfg["reduced"]:
            assert not key.endswith(("_dim", "_rank")) and key in data


def test_cell_added_by_files_alone(tmp_path):
    """A copy of the benchmark with one more cell, written as its traffic
    file and a BENCHMARK.json entry, loads and runs; no code is edited."""
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = dict(SPEC)
    spec["workloads"] = SPEC["workloads"] + [{
        "name": "c9_pool3_tiny", "config": "mercury_config9",
        "traffic": "pool3_tiny", "chips": 1, "why": "a test cell"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads(
        (harness.HERE / "workloads" / "c9_pool4096_clean.json").read_text())
    traffic.update(channels=3, ring_blocks=2, kept_every=1, traced_rounds=2)
    (tmp_path / "benchmark" / "workloads" / "c9_pool3_tiny.json").write_text(
        json.dumps(traffic))
    cell = harness.load_cell("c9_pool3_tiny", tmp_path)
    run, checks = harness.serve(cell, 2 ** 31 + 9, 0.5, False,
                                torch.device("cpu"), time.perf_counter(), {})
    assert harness.is_correct(checks)
    got = {m["name"]: harness.reader(m["name"], tmp_path)(run)
           for m in harness.cell_metrics(False, tmp_path)}
    assert set(got) == {"ingest_msamples_s", "round_p95_ms", "setup_s"}
    assert all(v > 0 for v in got.values())
