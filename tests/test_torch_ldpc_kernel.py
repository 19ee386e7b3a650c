"""The layered LDPC decode's packed plan and its plain version
(kernels.layered_decode_ref, what the ldpc_layered kernel is held to on the
card), on the CPU.

pack_plan is layer_plan without its padding, edge for edge, so the parity
of the plain version (which reads the packed tables) with the JAX
package's decode_mm also tests the tables the kernel reads. The plain
version is held to decode_mm at RxChain's call shapes, 8 rows a case:
min-sum (no transcendental) exact in bits, iters, ok and the posterior, at
the full cap and at set_ldpc_max_iter's cap of 5; SPA with soft=True
(BICM-ID) capped at 5 sweeps with `ok` exact, bits exact on converged rows
and iters within one sweep (last-ulp tanh/atanh differences between XLA
and PyTorch, as in tests/test_torch_ldpc.py). Kernel against plain version:
tests/test_torch_cuda.py (marker cuda) and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercury_tpu.fec import ldpc as jldpc
from mercury_tpu_torch.dsp import kernels
from mercury_tpu_torch.fec import ldpc
from mercury_tpu_torch.fec.tables import load_code
from mercury_tpu_torch.tools.roofline import (LDPC_FEW_SWEEPS,
                                              LDPC_POST_BARS, ldpc_agree)

RATES = (1, 2, 3, 4, 5, 6, 8, 14)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain decode calls tanh on small tensors, which MKL threads at a
    cost far above the work; one thread keeps the CPU decodes short."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _below_bound(rate):
    """A layer count below the disjoint bound: half the default's."""
    return max(2, ldpc.layer_plan(rate).shape[0] // 2)


def _layering(rate, kind):
    return {"default": None, "one": 1, "below": _below_bound(rate)}[kind]


@pytest.mark.parametrize("kind", ["default", "one", "below"])
@pytest.mark.parametrize("rate", RATES)
def test_pack_plan_is_layer_plan_without_padding(rate, kind):
    n_layers = _layering(rate, kind)
    plan = ldpc.pack_plan(rate, n_layers)
    padded = ldpc.layer_plan(rate, n_layers)
    code = load_code(rate)
    lp, cp, ev = (plan.layer_ptr.numpy(), plan.check_ptr.numpy(),
                  plan.edge_var.numpy())
    # each packed edge's (layer, row in layer, position, variable)
    check = np.repeat(np.arange(plan.n_checks), np.diff(cp))
    layer = np.repeat(np.arange(plan.n_layers), np.diff(lp))[check]
    row = check - lp[layer]
    pos = np.arange(plan.n_edges) - cp[check]
    want = np.nonzero(padded >= 0)
    for got, w in zip((layer, row, pos), want):
        np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(ev, padded[want])
    # the packed checks are the code's, each once, with its variables
    check_id = np.concatenate([np.asarray(m, dtype=np.int64) for m in
                               ldpc._layer_members(rate, n_layers)])
    assert sorted(check_id.tolist()) == list(range(code.p))
    np.testing.assert_array_equal(ev, code.c_idx[check_id[check], pos])
    assert plan.n_edges == int((code.c_idx >= 0).sum())
    assert (plan.n_layers, plan.max_layer_checks, plan.max_degree) == \
        padded.shape
    assert plan.max_degree <= 2 * plan.group <= 2 * 32
    assert plan.geometry.row_threads % 32 == 0
    assert plan.geometry.row_threads <= 512


@pytest.mark.parametrize("kind", ["default", "one", "below"])
@pytest.mark.parametrize("rate", RATES)
def test_pack_plan_variable_lists(rate, kind):
    """A layer's variables, each with its edges in ascending order, cover
    the layer's edges once; a plan is disjoint exactly when every variable
    of a layer has one edge, and only a grouped plan needs scratch."""
    plan = ldpc.pack_plan(rate, _layering(rate, kind))
    lp, cp, ev = (plan.layer_ptr.numpy(), plan.check_ptr.numpy(),
                  plan.edge_var.numpy())
    vp, vid, vep, ve = (plan.var_ptr.numpy(), plan.var_id.numpy(),
                        plan.var_edge_ptr.numpy(), plan.var_edge.numpy())
    one_each = True
    for l in range(plan.n_layers):
        e0, e1 = cp[lp[l]], cp[lp[l + 1]]
        edges = []
        for j in range(vp[l], vp[l + 1]):
            mine = ve[vep[j]: vep[j + 1]]
            assert (ev[mine] == vid[j]).all() and (np.diff(mine) > 0).all()
            one_each &= mine.size == 1
            edges.extend(mine)
        assert sorted(edges) == list(range(e0, e1))
        assert len(set(vid[vp[l]: vp[l + 1]])) == vp[l + 1] - vp[l]
    assert plan.disjoint == one_each
    scratch = int(np.diff(cp[lp]).max())
    assert plan.layer_scratch == (0 if plan.disjoint else scratch)


@pytest.mark.parametrize("rate", RATES)
def test_default_plans_are_disjoint(rate):
    """RxChain's layering (n_layers None) is variable-disjoint at every
    rate, and below the bound it is not: the kernel's direct path is the
    receive's, its grouped path a direct call's. A default plan's row
    (the posterior and the check messages, float32, in shared memory)
    fits the 48 KB a block gets without an opt-in."""
    plan = ldpc.pack_plan(rate)
    assert plan.disjoint
    assert not ldpc.pack_plan(rate, _below_bound(rate)).disjoint
    assert 4 * (plan.n + plan.n_edges + plan.layer_scratch) <= 48 * 1024


def _lane_edges(plan):
    """(layer, slot, lane, k, edge) of every edge a thread of the kernel
    reaches, walking csrc/ldpc_layered.cu's loops: thread j of a row is
    lane j % group of group j // group; it takes the slots base + c * ng +
    group (ng groups a row, c < checks_lane) of each layer, and in the
    check of a slot (first edge e0, degree d, kc = ceil(d / group)) the
    positions lane * kc + k, k < slots_lane."""
    geo, g = plan.geometry, plan.group
    words = plan.lane_check.numpy().astype(np.int64).reshape(
        plan.n_layers, plan.max_layer_checks)
    ng = geo.row_threads // g
    j = np.arange(geo.row_threads)
    lane, grp = j % g, j // g
    found = []
    for base in range(0, plan.max_layer_checks, ng * geo.checks_lane):
        for c in range(geo.checks_lane):
            slot = base + c * ng + grp
            inside = slot < plan.max_layer_checks
            w = np.where(inside[None, :],
                         words[:, np.minimum(slot, plan.max_layer_checks
                                             - 1)], 0)
            e0, deg = w & 0xFFFF, w >> 16
            kc = -(-deg // g)
            for k in range(geo.slots_lane):
                pos = lane[None, :] * kc + k
                has = (k < kc) & (pos < deg)
                lay, thr = np.nonzero(has)
                found.append(np.stack([lay, slot[thr], lane[thr],
                                       np.full(len(lay), k),
                                       (e0 + pos)[lay, thr]], axis=1))
    return np.concatenate(found)


@pytest.mark.parametrize("n_layers", [None, 1, 4])
@pytest.mark.parametrize("rate", RATES)
def test_lane_tables_place_every_edge_once(rate, n_layers):
    """The kernel's lane-order tables: walking the threads as the kernel
    does reaches every edge of check_ptr/edge_var exactly once, in the
    layer and check slot of its check and at the lane and slot lane * kc
    + k of its position, with the variable edge_var gives it; the first
    edges, degrees and variables fit in 16 bits."""
    plan = ldpc.pack_plan(rate, n_layers)
    lp, cp, ev = (plan.layer_ptr.numpy(), plan.check_ptr.numpy(),
                  plan.edge_var.numpy())
    got = _lane_edges(plan)
    lay, slot, lane, k, edge = got.T
    assert np.array_equal(np.sort(edge), np.arange(plan.n_edges))
    check = lp[lay] + slot
    assert (slot < np.diff(lp)[lay]).all()
    assert ((cp[check] <= edge) & (edge < cp[check + 1])).all()
    kc = -(-np.diff(cp)[check] // plan.group)
    np.testing.assert_array_equal(edge - cp[check], lane * kc + k)
    lane_var = plan.lane_var.numpy()
    assert lane_var.dtype == np.int16 and lane_var.min() >= 0
    np.testing.assert_array_equal(lane_var, ev)
    words = plan.lane_check.numpy().reshape(plan.n_layers, -1)
    for l in range(plan.n_layers):
        n_l = lp[l + 1] - lp[l]
        np.testing.assert_array_equal(words[l, :n_l] & 0xFFFF,
                                      cp[lp[l]: lp[l + 1]])
        np.testing.assert_array_equal(words[l, :n_l] >> 16,
                                      np.diff(cp)[lp[l]: lp[l + 1]])
        assert (words[l, n_l:] == 0).all()
    assert cp.max() < 1 << 16 and ev.max() < 1 << 15
    assert (-(-np.diff(cp) // plan.group)).max() <= plan.geometry.slots_lane


# rows an SM of a fixed-lane block (a row a block of min(512, max(256,
# the layer's lanes)) threads, four edge slots a lane, 40 registers), as
# the card's occupancy calculator gave them on an NVIDIA H100 80GB HBM3;
# a geometry's threads and shared memory must allow as many
ONE_ROW_ROWS_SM = {1: 2, 2: 2, 3: 2, 4: 2, 5: 2, 6: 2, 8: 2, 14: 4}


@pytest.mark.parametrize("n_layers", [None, 1, 4])
@pytest.mark.parametrize("rate", RATES)
def test_geometry_fits_the_card(rate, n_layers):
    """A plan's geometry (a block a row): its shared memory within 227 KB
    and as the kernel lays it out, its threads within the kernel's 512 and
    whole warps, a lane's edge slots within the kernel's two. A layer
    takes the fewest passes 512 threads allow, one check a lane where that
    takes no more passes, and a warp fewer would take more. An SM's 2048
    threads and 228 KB of shared memory (1 KB of it a block) allow at
    least two rows, and for the receive's layering at least as many as a
    fixed-lane block held, with a layer in one pass at every rate but 4/16
    and 5/16 (where one pass takes more than 512 threads)."""
    plan = ldpc.pack_plan(rate, n_layers)
    geo, g, m = plan.geometry, plan.group, plan.max_layer_checks
    assert geo.shared_bytes <= 227 * 1024 and geo.row_threads <= 512
    assert geo.row_threads % 32 == 0 and geo.row_threads % g == 0
    assert geo.checks_lane in (1, 2)
    assert geo.slots_lane == -(-plan.max_degree // g) <= 2
    assert geo.shared_bytes == kernels.ldpc_shared_bytes(
        plan.n, plan.n_edges, plan.layer_scratch, plan.n_layers, m)

    def passes(threads, checks):
        return -(-m // (threads // g * checks))

    assert geo.passes == passes(geo.row_threads, geo.checks_lane) \
        == passes(512, 2)
    assert (geo.checks_lane == 1) == (passes(512, 1) == geo.passes)
    if geo.row_threads > 32:
        assert passes(geo.row_threads - 32, geo.checks_lane) > geo.passes
    rows_sm = min(2048 // geo.row_threads,
                  228 * 1024 // (geo.shared_bytes + 1024))
    assert rows_sm >= 2
    if n_layers is None:
        assert rows_sm >= ONE_ROW_ROWS_SM[rate]
        assert (geo.passes == 1) == (rate not in (4, 5))


def _noisy(rate, sigma, seed, rows=8):
    code = load_code(rate)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (rows, code.k))
    cw = np.asarray(jldpc.encode(code, jnp.asarray(u)))
    y = (1 - 2 * cw) + sigma * rng.standard_normal(cw.shape)
    return cw, (2 / sigma ** 2 * y).astype(np.float32)


# (rate, sigma, max_iter): rows that converge and rows that do not
MINSUM = [(1, 2.5, 50), (4, 1.3, 50), (8, 0.9, 50), (14, 0.5, 5)]


@pytest.mark.parametrize("rate,sigma,max_iter", MINSUM)
def test_plain_minsum_soft_exact(rate, sigma, max_iter):
    """The receive's min-sum decoder (ldpc_algo "layered-minsum") with the
    posterior out: every output equal to decode_mm's, converged or not."""
    cw, llr = _noisy(rate, sigma, rate + max_iter)
    dec = ldpc.LayeredDecoder(rate, max_iter, algo="minsum")
    bits, iters, ok, post = (a.numpy() for a in dec(torch.as_tensor(llr),
                                                    soft=True))
    bits_j, iters_j, ok_j, post_j = (np.asarray(a) for a in jldpc.decode_mm(
        jnp.asarray(llr), rate, max_iter=max_iter, algo="minsum", soft=True))
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_array_equal(iters, iters_j)
    np.testing.assert_array_equal(bits, bits_j)
    np.testing.assert_array_equal(post, post_j)
    assert ok.any() and not ok.all()
    assert (bits[ok] == cw[ok]).all() and (iters[~ok] == max_iter + 1).all()


def test_plain_spa_soft_capped():
    """BICM-ID's call (SPA, soft=True) under set_ldpc_max_iter(5): ok
    equal, bits equal on converged rows, iters within one sweep there and
    6 on the rows left, the posterior's signs the decisions."""
    cw, llr = _noisy(8, 0.8, 3)
    bits, iters, ok, post = (a.numpy() for a in ldpc.LayeredDecoder(8, 5)(
        torch.as_tensor(llr), soft=True))
    bits_j, iters_j, ok_j, _post_j = (np.asarray(a) for a in jldpc.decode_mm(
        jnp.asarray(llr), 8, max_iter=5, soft=True))
    np.testing.assert_array_equal(ok, ok_j)
    np.testing.assert_array_equal(bits[ok], bits_j[ok])
    assert np.abs(iters - iters_j)[ok].max() <= 1
    assert (iters[~ok] == 6).all() and ok.any() and not ok.all()
    assert (bits[ok] == cw[ok]).all()
    np.testing.assert_array_equal(bits, (post < 0).astype(bits.dtype))


def test_decoder_goes_through_the_wrapper(monkeypatch):
    """LayeredDecoder.forward is one call of kernels.ldpc_layered on its
    plan; on a CPU tensor that is the plain version, and no kernel launch
    is counted."""
    calls = []
    wrapper = kernels.ldpc_layered

    def noted(llr, plan, *args):
        calls.append((plan.rate_num, plan.n_layers, args))
        return wrapper(llr, plan, *args)
    monkeypatch.setattr(kernels, "ldpc_layered", noted)
    before = kernels.LAUNCHES["ldpc_layered"]
    _cw, llr = _noisy(4, 1.0, 7, rows=2)
    dec = ldpc.LayeredDecoder(4, 7, algo="minsum", beta=0.25)
    got = dec(torch.as_tensor(llr), soft=True)
    plan = ldpc.pack_plan(4)
    assert calls == [(4, plan.n_layers, (7, "minsum", dec.alpha, 0.25,
                                         True))]
    want = kernels.layered_decode_ref(torch.as_tensor(llr), plan, 7,
                                      "minsum", dec.alpha, 0.25, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert kernels.LAUNCHES["ldpc_layered"] == before


def test_wrapper_has_no_fallback():
    """A tensor on neither the CPU nor a CUDA card is refused, not decoded
    by the plain version."""
    plan = ldpc.pack_plan(8)
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.ldpc_layered(torch.zeros((2, plan.n), device="meta"), plan,
                             5)


def _faulty(kind, decode):
    """decode (bits, iters, ok, posterior) with one planted difference."""
    bits, iters, ok, post = (t.clone() for t in decode)
    row = int(ok.nonzero()[0])
    if kind == "posterior off":
        atol = max(limit for limit, _share in LDPC_POST_BARS.values())
        post[row, 0] += 2 * atol * torch.sign(post[row, 0])
    elif kind == "posterior off by an ulp everywhere":
        post = torch.nextafter(post, 2 * post)
    elif kind == "ok flipped":
        ok[row] = False
    elif kind == "bits flipped":
        bits[row, 0] ^= 1
        post[row, 0] = -post[row, 0]
    elif kind == "iters two apart":
        iters[row] += 2
    return bits, iters, ok, post


@pytest.mark.parametrize("algo", ["spa", "minsum"])
@pytest.mark.parametrize("kind", ["none", "posterior off",
                                  "posterior off by an ulp everywhere",
                                  "ok flipped", "bits flipped",
                                  "iters two apart"])
def test_agreement_rule(kind, algo):
    """roofline.ldpc_agree, the bar the kernel is held to on the card,
    passes an equal decode and fails each planted difference: on 8 rows
    the 1% allowance for ok is none, a few-sweep SPA posterior is held
    element by element, and min-sum allows no difference at all."""
    _cw, llr = _noisy(8, 0.6, 3)
    want = kernels.layered_decode_ref(torch.as_tensor(llr),
                                      ldpc.pack_plan(8), LDPC_FEW_SWEEPS,
                                      algo, soft=True)
    assert want[2].any()
    got = _faulty(kind, want)
    if kind == "none":
        ldpc_agree(got, want, algo, kind, LDPC_FEW_SWEEPS)
    else:
        with pytest.raises(AssertionError):
            ldpc_agree(got, want, algo, kind, LDPC_FEW_SWEEPS)
