"""Meshes over processes (scale/dist.py, the multi-process forms of
scale/shard.py) on the CPU: two real ranks over gloo, their rendezvous a
file store under tmp_path, started by scale.dist's launcher; the ranks run
tests/test_torch_dist_ranks.py (no JAX) while this process computes the JAX
package's receives on the conftest's 8-device CPU mesh.

Every rank returns the whole result. Against the one-process programs on
the same numpy inputs: payload, crc_ok, delay and iters exact, the float
fields within 1e-6 (the same operations on the same rows); against the
JAX package's time_sharded_receive (2 x 2 and 2-device meshes): payload,
crc_ok and delay exact, freq_offset within 0.01 Hz, snr_db within 0.05
dB; channel-parallel against the unsharded receive at
tests/test_torch_shard.py's bar (decisions exact, snr_db and mean_h rtol
1e-5), time_sharded_fir against ops.fir_same at its bar (rtol 1e-5, atol
1e-6). Three launches of the ranks: the forms, BENCH as ranks bringing up
their own group, and a rank that fails."""

import concurrent.futures
import json
import pathlib
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dist_ranks as ranks_mod
from mercury_tpu.core.geometry import build_geometry as jax_geometry
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu.scale import shard as jshard
from mercury_tpu_torch.core.geometry import build_geometry
from mercury_tpu_torch.dsp import ops
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.scale import analysis, dist, shard

RANKS = pathlib.Path(ranks_mod.__file__).resolve()
# BENCH as a rank started with torchrun's environment: it brings up its own
# group (--cpu: on the CPU), at batch 2 and one rep
BENCH_RANK = ("import sys; from mercury_tpu_torch import bench; "
              "sys.exit(bench.main(['--cpu'], batch=2, reps=1))")
FLOATS = ("freq_offset", "snr_db", "sync_metric", "mean_h")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_receive(x, two_d: bool) -> dict:
    rx = JaxRx(jax_geometry(16))
    if two_d:
        run = jshard.time_sharded_receive(
            rx, jshard.make_mesh_2d(2, 2, axes=("dcn", "t")), time_axis="t",
            batch_axis="dcn")
    else:
        run = jshard.time_sharded_receive(rx, jshard.make_mesh(2, axis="t"),
                                          time_axis="t")
    res = run(jnp.asarray(x))
    return {f: np.asarray(getattr(res, f))
            for f in ("payload", "crc_ok", "delay", "freq_offset",
                      "snr_db")}


def _one_process(g, x) -> dict:
    """The same forms in this process: one-process meshes of CPU shards,
    the unsharded CONFIG_9 receive and ops.fir_same."""
    rx = RxChain(g, device="cpu")
    xs, _ = ranks_mod.stream_blocks(g)
    g9 = build_geometry(9)
    buf, _ = ranks_mod.channels(g9)
    xf, taps = ranks_mod.fir_input()
    return {
        "a": shard.time_sharded_receive(
            rx, shard.make_mesh_2d(2, 2, axes=("dcn", "t"),
                                   devices=["cpu"] * 4),
            time_axis="t", batch_axis="dcn")(torch.as_tensor(x)),
        "b": shard.time_sharded_receive(
            rx, shard.make_mesh(2, axis="t", devices=["cpu"] * 2))(
                torch.as_tensor(x)),
        "stream": shard.time_sharded_receive_stream(
            rx, shard.make_mesh(2, axis="t", devices=["cpu"] * 2),
            n_blocks=2)(torch.as_tensor(xs)),
        "c": RxChain(g9, device="cpu").receive(torch.as_tensor(buf)),
        "fir": ops.fir_same(torch.as_tensor(xf), torch.as_tensor(taps)),
    }


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The two ranks' forms and BENCH under a group, launched while the JAX
    package's two receives compile and run here, beside the one-process
    forms."""
    g = build_geometry(16)
    x, _ = ranks_mod.stream_2d(g)
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        forms = pool.submit(dist.run_ranks, f"{RANKS}:forms", 2,
                            tmp_path_factory.mktemp("forms"),
                            devices=["cpu"], timeout=300)
        bench = pool.submit(dist.launch, ["-c", BENCH_RANK], 2,
                            tmp_path_factory.mktemp("bench"), timeout=300)
        jax_2d = pool.submit(_jax_receive, x, True)
        jax_1d = pool.submit(_jax_receive, x, False)
        one = pool.submit(_one_process, g, x)
        return {"forms": forms.result()[0], "bench": bench.result(),
                "jax 2d": jax_2d.result(), "jax 1d": jax_1d.result(),
                "one": one.result(), "x": x, "g": g}


def _equal_results(got: dict, want) -> None:
    for f in ("payload", "crc_ok", "delay", "iters"):
        assert torch.equal(got[f], getattr(want, f)), f
    for f in FLOATS:
        torch.testing.assert_close(got[f], getattr(want, f), rtol=0,
                                   atol=1e-6)


def _against_jax(got: dict, want: dict) -> None:
    for f in ("payload", "crc_ok", "delay"):
        np.testing.assert_array_equal(got[f].numpy(), want[f], err_msg=f)
    np.testing.assert_allclose(got["freq_offset"].numpy(),
                               want["freq_offset"], rtol=0, atol=0.01)
    np.testing.assert_allclose(got["snr_db"].numpy(), want["snr_db"],
                               rtol=0, atol=0.05)


def test_choose_backend():
    assert dist.choose_backend([["a"], ["b"]]) == "nccl"
    assert dist.choose_backend([["a", "b"], ["c"]]) == "nccl"
    assert dist.choose_backend([["a"], ["a"]]) == "gloo"       # one card
    assert dist.choose_backend([[], []]) == "gloo"             # the CPU
    assert dist.choose_backend([["a"], []]) == "gloo"


def test_init_takes_the_card_unless_given_devices():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        dist.init(rank=0, world_size=1, init_method="file:///nonexistent")


def test_mesh_2d_across_processes(ran):
    """(a) dcn across the two ranks, t two virtual shards within each:
    every rank's result is the one-process 2 x 2 mesh's and the JAX
    program's; no halo or dedupe crosses the ranks."""
    one = ran["one"]["a"]
    _, want = ranks_mod.stream_2d(ran["g"])
    assert set(zip(*np.nonzero(one.crc_ok.numpy()))) == set(want)
    for rank, out in enumerate(ran["forms"]):
        a = out["a"]
        assert a["ranks"] == [[0, 0], [1, 1]]
        _equal_results(a["res"], one)
        _against_jax(a["res"], ran["jax 2d"])
        moves = analysis.logged_transfers(a["log"])
        assert moves == {"halo": 1, "dedupe": 1}, (rank, moves)
        # rank r drives group r: its transfers stay within it
        assert all(e["src"].startswith(f"dcn{rank}.") for e in a["log"]
                   if "src" in e)
        gathers = [e for e in a["log"] if e["kind"] == "gather"]
        assert len(gathers) == 1 and gathers[0]["ranks"] == 2


def test_time_axis_across_processes(ran):
    """(b) one shard a rank: every halo and dedupe crosses the ranks, each
    halo B x (the account's halo less the 8 dedupe bytes) and each dedupe
    B x 8 bytes; results those of the one-process 2-shard mesh and of
    JAX's 2-device receive."""
    one = ran["one"]["b"]
    halo = analysis.collective_account(ran["g"])["time_sharded_rx"][
        "halo_bytes_per_shard_block"] - 8
    b = ran["x"].shape[0]
    for rank, out in enumerate(ran["forms"]):
        res, log = out["b"]["res"], out["b"]["log"]
        _equal_results(res, one)
        _against_jax(res, ran["jax 1d"])
        assert analysis.logged_transfers(log) == {
            "halo across processes": 1, "dedupe across processes": 1}
        for e in log:
            if "src" in e:
                assert {e["src_rank"], e["dst_rank"]} == {0, 1}
                assert not e["staged"]                  # CPU tensors
                assert e["bytes"] == b * (halo if e["kind"] == "halo"
                                          else 8), e
                assert (e["src_rank"] == rank) == (e["src"] == f"t{rank}")


def test_stream_form_across_processes(ran):
    """The stream form over K = 2 blocks with the time axis across the
    ranks: the one-process program's result, every frame claimed once by
    its slice, and each rank's log double-buffered (block 1's halo issued
    before block 0 decodes and, on the rank it is bound for, waited on
    after)."""
    _, want = ranks_mod.stream_blocks(ran["g"])
    one = ran["one"]["stream"]
    claims = {(2 * k + j, r)
              for k, j, r in zip(*np.nonzero(one.crc_ok.numpy()))}
    assert claims == set(want)
    for (sl, r), (start, payload) in want.items():
        k, j = divmod(sl, 2)
        assert abs(int(one.delay[k, j, r]) - start) <= 16
        assert (one.payload[k, j, r].numpy() == payload).all()
    for out in ran["forms"]:
        _equal_results(out["stream"]["res"], one)
        rep = analysis.audit_overlap_structure(out["stream"]["log"])
        assert rep["overlap_scheduled"], rep
        assert rep["transfers"] == {"halo across processes": 3,
                                    "dedupe across processes": 3}


def test_channel_parallel_across_processes(ran):
    """(c) CONFIG_9 over 4 shards, 2 a rank: the unsharded receive on every
    rank; no transfer between shards, one gather."""
    _, payload = ranks_mod.channels(build_geometry(9))
    ref = ran["one"]["c"]
    assert ref.crc_ok.all() and (ref.payload.numpy() == payload).all()
    for out in ran["forms"]:
        res = out["c"]["res"]
        for f in ("payload", "crc_ok", "delay", "iters", "freq_offset",
                  "sync_metric"):
            assert torch.equal(res[f], getattr(ref, f)), f
        for f in ("snr_db", "mean_h"):
            torch.testing.assert_close(res[f], getattr(ref, f), rtol=1e-5,
                                       atol=0)
        assert analysis.logged_transfers(out["c"]["log"]) == {}
        assert [e["kind"] for e in out["c"]["log"]] == ["gather"]


def test_fir_across_processes(ran):
    """time_sharded_fir over 4 shards, 2 a rank: ops.fir_same's output on
    every rank; 6 halos, the 2 at the ranks' seam across processes."""
    for out in ran["forms"]:
        torch.testing.assert_close(out["fir"]["y"], ran["one"]["fir"],
                                   rtol=1e-5,
                                   atol=1e-6)
        assert analysis.logged_transfers(out["fir"]["log"]) == {
            "halo": 2, "halo across processes": 2}


def test_layouts_that_cannot_be_laid(ran):
    """(d) ValueError on every rank, none left waiting on another."""
    for out in ran["forms"]:
        d = out["d"]
        assert "does not divide over 2 processes" in d["n over ranks"]
        assert "outer axis of 3 does not divide" in d["outer over ranks"]
        assert "needs 2 devices a process" in d["too few devices"]
        assert "process 1 has 1" in d["one rank short"]
        assert "hold none of process 1's devices" in d["inner axis only"]


def test_process_link_rate(ran):
    rates = [out["rate"] for out in ran["forms"]]
    assert rates[0] == rates[1] and rates[0] > 0


def test_bench_under_a_process_group(ran):
    """BENCH as two ranks started with torchrun's environment: each brings
    up the group itself, rank 0 prints the line with the link measured
    between the processes, rank 1 only takes part in it (both exit 0, or
    the launch raises)."""
    logs = ran["bench"]
    lines = [[ln for ln in text.splitlines() if ln.startswith("{")]
             for text in logs]
    assert len(lines[0]) == 1 and lines[1] == [], logs
    line = json.loads(lines[0][0])
    assert line["platform"] == "cpu" and line["warmup_decoded"] == 2
    sc = line["scaling"]
    assert sc["link"] == "process" and sc["link_bytes_per_s"] > 0
    assert sc["time_sharded_overlap_scheduled"]
    assert "rank 1 of 2 on cpu: gloo" in logs[1]


def test_launch_fails_fast_when_a_rank_fails(tmp_path):
    """A rank that raises fails the launch at once, its error in the
    message, and the rank left waiting for it stops (its barrier fails as
    the peer goes, or the launcher kills it)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank [01] exited with") as err:
        dist.run_ranks(f"{RANKS}:fail_on_rank_1", 2, tmp_path,
                       devices=["cpu"], timeout=120)
    assert "rank 1 fails on purpose" in str(err.value)
    assert time.monotonic() - t0 < 60
