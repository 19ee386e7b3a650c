"""scale/shard.py and scale/analysis.py of mercury_tpu_torch against the JAX
package's, on CPU meshes (a list of devices, here all 'cpu'; the JAX side
on the conftest's virtual 8-device CPU mesh).

The time-sharded stream form takes bench.py's audit_worker size (CONFIG_16,
2 shards, 2 blocks of the standard buffer a shard) with frames straddling
a shard seam and a block seam and frames 4 samples before a seam, which
both neighbours decode and the seam dedupe keeps once: claims, global
delays and claimed payloads equal the JAX program's, and every frame is
claimed exactly once within 16 samples of its start. Channel-parallel
equals the unsharded receive in its decisions (crc_ok, payload, delay,
iters, freq_offset, sync_metric exact; snr_db and mean_h, whose float32
reductions differ with the batch size, rtol 1e-5). time_sharded_fir
against JAX's on 8 shards and the unsharded ops.fir_same, rtol 1e-5 /
atol 1e-6 (tests/test_scale.py's bar). The transfer-log audits stand for
the JAX package's HLO audits, with a serialized schedule as the
counter-example."""

import threading
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.core.geometry import build_geometry
from mercury_tpu.dsp import ops as jops
from mercury_tpu.modem.rx import RxChain as JaxRx
from mercury_tpu.scale import analysis as janalysis
from mercury_tpu.scale import shard as jshard
from mercury_tpu_torch.channel import sim
from mercury_tpu_torch.core.geometry import build_geometry as port_geometry
from mercury_tpu_torch.dsp import kernels, ops
from mercury_tpu_torch.modem.rx import RxChain
from mercury_tpu_torch.modem.tx import TxChain
from mercury_tpu_torch.scale import analysis, shard


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_state():
    # as tests/test_scale.py: SPMD lowerings of the full receive on top of
    # a suite's accumulated compile state have crashed the XLA CPU compiler
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    jax.clear_caches()
    yield
    jax.clear_caches()
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cfg16():
    g = port_geometry(16)
    return g, RxChain(g, device="cpu")


def _cpu_mesh(n: int, axis: str = "t") -> shard.Mesh:
    return shard.make_mesh(n, axis=axis, devices=["cpu"] * n)


def _frames(g, n: int, seed: int):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, (n, g.frame_bytes)).astype(np.uint8)
    frames = TxChain(g, device="cpu").transmit(torch.as_tensor(payload))
    return payload, frames.numpy(), rng


def test_mesh_construction():
    mesh = shard.make_mesh(4, axis="t", devices=["cpu"] * 6)
    assert mesh.shape == {"t": 4}
    assert all(d == torch.device("cpu") for d in mesh.devices)
    m2 = shard.make_mesh_2d(2, 3, axes=("dcn", "t"), devices=["cpu"] * 6)
    assert m2.shape == {"dcn": 2, "t": 3}
    assert len(m2.axis_devices("t", 1)) == 3
    assert len(m2.axis_devices("dcn", 2)) == 2
    parts = shard.shard_batch(mesh, torch.arange(24).reshape(8, 3), "t")
    assert [p.shape for p in parts] == [(2, 3)] * 4
    assert torch.equal(torch.cat(parts), torch.arange(24).reshape(8, 3))
    with pytest.raises(ValueError, match="needs more"):
        shard.make_mesh(3, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="does not split"):
        shard.shard_batch(mesh, torch.zeros(6, 3), "t")


def test_channel_parallel_matches_unsharded(cfg16):
    g, rx = cfg16
    payload, frames, rng = _frames(g, 8, 0)
    n = g.nofdm * g.buffer_nsymb * g.interp
    buf = (rng.standard_normal((8, n)) * sim.sigma_for_esn0(31.0)
           ).astype(np.float32)
    for r in range(8):
        d = 3000 + 411 * r
        buf[r, d: d + frames.shape[1]] += frames[r]
    run = shard.channel_parallel_receive(rx, _cpu_mesh(4, "ch"), axis="ch")
    res = run(torch.as_tensor(buf))
    ref = rx.receive(torch.as_tensor(buf))
    assert res.crc_ok.all() and (res.payload.numpy() == payload).all()
    for f in ("payload", "crc_ok", "delay", "iters", "freq_offset",
              "sync_metric"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    for f in ("snr_db", "mean_h"):
        torch.testing.assert_close(getattr(res, f), getattr(ref, f),
                                   rtol=1e-5, atol=0)
    # each shard its own chain; nothing moved between shards
    assert len({id(sh.rx) for sh in run.shards} | {id(rx)}) == 5
    assert run.log == [] and analysis.logged_transfers(run) == {}


def _stream_case(g):
    """Three streams of K=2 blocks over 2 shards (4 slices of n_local).
    Row 0: a frame mid slice 0, one 8 samples before the block seam (slice
    1's, which slice 2 decodes too from its head), one mid slice 3. Row 1:
    one 8 samples before the shard seam (slice 0's, decoded by slice 1
    too), one straddling the seam of slices 2 and 3 and one in slice 3
    after it. Row 2: frames mid slices 0 and 3 and one 4 samples before the
    block seam, claimed by slice 2 alone (slice 1's matched-filter peak
    falls on its limit, where it is masked out, in the JAX program as
    here). -> (stream [3, 2, 2 n_local],
    {(row, claiming slice): (start, payload)})."""
    n = g.nofdm * g.buffer_nsymb * g.interp
    frame_len = g.nofdm * (g.nsymb + g.preamble_nsymb) * g.interp
    plan = {(0, 0): 20000, (0, 1): 2 * n - 8, (0, 3): 3 * n + 20000,
            (1, 0): n - 8, (1, 2): 3 * n - frame_len // 3,
            (1, 3): 3 * n + 30000,
            (2, 0): 20000, (2, 2): 2 * n - 4, (2, 3): 3 * n + 20000}
    payload, frames, rng = _frames(g, len(plan), 7)
    stream = (0.002 * rng.standard_normal((3, 4 * n))).astype(np.float32)
    want = {}
    for i, (key, start) in enumerate(plan.items()):
        stream[key[0], start: start + frame_len] += frames[i]
        want[key] = (start, payload[i])
    return stream.reshape(3, 2, 2 * n), want


def test_time_sharded_stream_matches_jax(cfg16):
    g, rx = cfg16
    stream, want = _stream_case(g)
    run = shard.time_sharded_receive_stream(rx, _cpu_mesh(2), n_blocks=2)
    res = run(torch.as_tensor(stream))
    claim = res.crc_ok.numpy()                       # [K, n_dev, B]
    delay = res.delay.numpy()
    got = res.payload.numpy()
    assert claim.shape == (2, 2, 3)
    claimed = {(r, 2 * k + j) for k, j, r in zip(*np.nonzero(claim))}
    assert claimed == set(want)
    for (r, sl), (start, payload) in want.items():
        k, j = divmod(sl, 2)
        assert abs(int(delay[k, j, r]) - start) <= 16, (r, sl)
        assert (got[k, j, r] == payload).all()
    # the right-hand neighbours decoded the seam-minus-8 frames too (row
    # 0's across the block seam, in slice 2; row 1's in slice 1) and the
    # dedupe dropped their claims: (block, shard, row) -> the frame
    for (k, j, r), key in (((1, 0, 0), (0, 1)), ((0, 1, 1), (1, 0))):
        assert not claim[k, j, r]
        assert (got[k, j, r] == want[key][1]).all()

    jrun = jshard.time_sharded_receive_stream(
        JaxRx(build_geometry(16)), jshard.make_mesh(2, axis="t"),
        n_blocks=2, time_axis="t")
    res_j = jrun(jnp.asarray(stream))
    np.testing.assert_array_equal(claim, np.asarray(res_j.crc_ok))
    np.testing.assert_array_equal(delay[claim], np.asarray(res_j.delay)[claim])
    np.testing.assert_array_equal(got[claim], np.asarray(res_j.payload)[claim])

    # the log: halo k+1 issued before decode k, consumed after it
    rep = analysis.audit_overlap_structure(run)
    assert rep["overlap_scheduled"], rep
    assert not rep["blocking_upstream"] and not rep["blocking_downstream"]
    halo = g.nofdm * (g.nsymb + g.preamble_nsymb) * g.interp \
        + 2 * g.nofdm * g.interp
    assert rep["halo_bytes"] == 3 * halo * 4          # B = 3 rows
    assert rep["transfers"] == {"halo": 3, "dedupe": 3}


def test_overlap_audit_rejects_serialized_exchange():
    """The audit is falsifiable: a schedule that issues each block's halo
    after the previous block's decode and decodes on it at once is not
    overlapped."""
    log = []
    for k in range(3):
        log.append({"kind": "halo", "block": k, "bytes": 512, "src": "t1",
                    "dst": "t0"})
        log.append({"kind": "wait", "block": k, "dst": "t0"})
        log.append({"kind": "decode", "block": k})
        log.append({"kind": "decoded", "block": k})
    for i, e in enumerate(log):
        e["seq"] = i
    rep = analysis.audit_overlap_structure(log)
    assert rep["overlap_scheduled"] is False
    assert rep["blocking_upstream"] == [1, 2]
    assert rep["blocking_downstream"] == [1, 2]
    assert not analysis.audit_overlap_structure(log[:4])["overlap_scheduled"]


def test_time_sharded_2d_mesh(cfg16):
    """A 2 x 2 (dcn, t) mesh: each group time-shards its own stream, every
    frame is claimed by its (group, slice), and no transfer crosses
    groups."""
    g, rx = cfg16
    n = g.nofdm * g.buffer_nsymb * g.interp
    # (slice, row) -> start; row 1's frame 8 samples before the seam is
    # decoded by both of its group's shards and claimed by the left one
    plan = {(0, 0): 2000, (1, 0): n + 9000, (0, 1): n - 8}
    payload, frames, rng = _frames(g, len(plan), 11)
    x = (0.002 * rng.standard_normal((2, 2 * n))).astype(np.float32)
    for i, ((_j, r), start) in enumerate(plan.items()):
        x[r, start: start + frames.shape[1]] += frames[i]
    mesh2 = shard.make_mesh_2d(2, 2, axes=("dcn", "t"),
                               devices=["cpu"] * 4)
    run = shard.time_sharded_receive(rx, mesh2, time_axis="t",
                                     batch_axis="dcn")
    res = run(torch.as_tensor(x))                    # [n_dev, B]
    assert set(zip(*np.nonzero(res.crc_ok.numpy()))) == set(plan)
    for i, (key, start) in enumerate(plan.items()):
        assert abs(int(res.delay[key]) - start) <= 16
        assert (res.payload[key].numpy() == payload[i]).all()
    assert (res.payload[1, 1].numpy() == payload[2]).all()     # deduped
    moves = [e for e in run.log if "bytes" in e]
    assert moves and all(e["src"].split(".")[0] == e["dst"].split(".")[0]
                         for e in moves)


def test_time_sharded_fir_matches_jax():
    g = build_geometry(0)
    taps = g.fir_rx_data.astype(np.float32)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8 * 4096)).astype(np.float32)
    f = shard.time_sharded_fir(_cpu_mesh(8), taps)
    got = f(torch.as_tensor(x)).numpy()
    want = ops.fir_same(torch.as_tensor(x), torch.as_tensor(taps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    mesh_j = jshard.make_mesh(8, axis="t")
    xs = jax.device_put(x, jax.sharding.NamedSharding(
        mesh_j, jax.sharding.PartitionSpec(None, "t")))
    want_j = np.asarray(jshard.time_sharded_fir(mesh_j, taps)(xs))
    np.testing.assert_allclose(got, want_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        want, np.asarray(jops.fir_same(jnp.asarray(x), jnp.asarray(taps))),
        rtol=1e-5, atol=1e-6)
    # 7 seams, a halo each way
    halos = [e for e in f.log if e["kind"] == "halo"]
    assert len(halos) == 14
    assert {e["bytes"] for e in halos} == {2 * 16 * 4}


@pytest.mark.parametrize("cfg", [9, 16])
def test_collective_account_matches_jax(cfg):
    g_j, g = build_geometry(cfg), port_geometry(cfg)
    assert analysis.collective_account(g) == janalysis.collective_account(g_j)
    got = analysis.predicted_efficiency(2600.0, g,
                                        link_bytes_per_s=12.5e9)
    want = janalysis.predicted_efficiency(2600.0, g_j,
                                          link_bytes_per_s=12.5e9)
    assert got == want
    assert "ICI_BYTES_PER_S" not in vars(analysis)


def test_scaling_structure_table_matches_account():
    """Channel-parallel logs no transfer at any mesh size; the time-sharded
    receive moves one halo and one dedupe row a shard and block, the
    analytic account's bytes."""
    g = port_geometry(16)
    rx = RxChain(g, device="cpu", dd=False, bicm_iters=0, ldpc_max_iter=2)
    rows = analysis.scaling_structure_table(rx, device_counts=(2, 3),
                                            device="cpu")
    assert [r["devices"] for r in rows] == [2, 3]
    for r in rows:
        assert r["channel_parallel_transfers"] == {}
        assert (r["ts_transfer_bytes_per_device"]
                == r["ts_analytic_halo_bytes_per_device"])


def test_launch_counts_survive_threads():
    """The kernels' launch counter under 8 threads and a short switch
    interval: no lost update."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    kernels.reset_launch_counts()
    try:
        def hammer():
            for _ in range(2000):
                kernels._count("deep_mf_score")

        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert kernels.LAUNCHES["deep_mf_score"] == 8 * 2000
    finally:
        sys.setswitchinterval(prev)
        kernels.reset_launch_counts()
