"""LDPC encode and decode (PyTorch port of the JAX package's `fec/ldpc.py`):
`encode`; the layered decoder of `decode_mm` (SPA or offset min-sum check
update, any layer count, optional posterior output); the flooding decoder
of `decode`; and gradient bit-flipping, `decode_gbf`.

The JAX layered decoder moves messages with one-hot incidence matmuls whose
data operand is bfloat16. Here the same moves are a gather and a scatter-add,
and the data side is rounded to bfloat16 at exactly the points where the JAX
matmuls round it: the posterior read into the check update, and the
posterior delta written back. Syndromes are integer parity counts.

Every decoder keeps the JAX contract: iters is 0 for a row whose hard
decisions already satisfy every check, the iteration at which it converged
otherwise, and max_iter+1 for a row that never converges; converged rows are
frozen. The loop ends when every row is done or the cap is reached, with one
host-side read of the done mask per iteration.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from mercury_tpu_torch.fec.tables import LdpcCode, load_code

# Normalized min-sum scale per rate, calibrated in the JAX package at each
# rate's FER~0.3 threshold against SPA: low-rate IRA codes with their mostly
# degree-3 checks want alpha near 1, high-rate near 0.7.
MINSUM_ALPHA = {1: 0.95, 2: 0.925, 3: 0.9, 4: 0.85, 5: 0.75, 6: 0.75,
                8: 0.7, 14: 0.7}
_BIG = 3.0e38


def encode(gen: torch.Tensor, info_bits: torch.Tensor) -> torch.Tensor:
    """info_bits [B, K] in {0,1} -> codeword [B, N] int64, with gen the
    [P, K] float32 generator block (parity = gen @ u mod 2). The products
    are 0/1 and the sums at most K, so float32 is exact even under TF32."""
    parity = torch.remainder(info_bits.to(torch.float32) @ gen.T, 2.0)
    return torch.cat([info_bits.long(), parity.long()], dim=-1)


# ---------------------------------------------------------------------------
# Layer plan (host numpy, identical to the JAX package's)
# ---------------------------------------------------------------------------

def _assign_layers(c_idx: np.ndarray, n_layers: int) -> list[list[int]]:
    """Balanced layer assignment: each check goes to the least-loaded layer
    that shares none of its variables, else the least-loaded open layer;
    checks are placed in descending-degree order."""
    p = c_idx.shape[0]
    varsets = [frozenset(int(v) for v in row if v >= 0) for row in c_idx]
    order = sorted(range(p), key=lambda i: -len(varsets[i]))
    cap = -(-p // n_layers)
    used: list[set] = [set() for _ in range(n_layers)]
    members: list[list[int]] = [[] for _ in range(n_layers)]
    for i in order:
        open_layers = [l for l in range(n_layers) if len(members[l]) < cap]
        disjoint = [l for l in open_layers if not (varsets[i] & used[l])]
        pool = disjoint or open_layers
        l = min(pool, key=lambda j: len(members[j]))
        used[l] |= varsets[i]
        members[l].append(i)
    return members


def _is_disjoint(code: LdpcCode, members: list[list[int]]) -> bool:
    for layer in members:
        seen: set = set()
        for i in layer:
            row = frozenset(int(v) for v in code.c_idx[i] if v >= 0)
            if row & seen:
                return False
            seen |= row
    return True


@functools.lru_cache(maxsize=None)
def layer_plan(rate_num: int, n_layers: int | None = None) -> np.ndarray:
    """[L, Pl, Cw] check -> variable indices (-1 pad). n_layers None: the
    smallest balanced variable-disjoint layering (searched from the maximum
    variable degree upward); 1: every check in one layer (the flooding
    schedule); k: k balanced layers (grouped-shuffled below the disjoint
    bound)."""
    code = load_code(rate_num)
    p, cw = code.p, code.cw
    if n_layers == 1:
        members = [list(range(p))]
    elif n_layers is not None:
        members = _assign_layers(code.c_idx, n_layers)
    else:
        for n_try in range(int(code.deg.max()), p + 1):
            members = _assign_layers(code.c_idx, n_try)
            if _is_disjoint(code, members):
                break
        else:
            members = _assign_layers(code.c_idx, p)
    pl = max(len(m) for m in members)
    c_idx = np.full((len(members), pl, cw), -1, dtype=np.int64)
    for l, m in enumerate(members):
        c_idx[l, : len(m)] = code.c_idx[m]
    return c_idx


# ---------------------------------------------------------------------------
# Check-node updates
# ---------------------------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to bfloat16 and back (round to nearest even)."""
    return x.to(torch.bfloat16).to(torch.float32)


def check_node_update(q: torch.Tensor, mask: torch.Tensor, algo: str = "spa",
                      alpha: float = 1.0, beta: float = 0.0) -> torch.Tensor:
    """Check update on edge messages q [B, P, Cw] (mask [P, Cw]); 0 on
    padded edges.

    "spa": R = 2 atanh(prod_{other edges} tanh(q/2)), exclusive products
    from forward/backward cumulative products. "minsum": offset min-sum,
    R = sign_excl * clip(alpha * max(min_excl - beta, 0), 0, 8.7), the
    exclusive minimum from (min1, min2, first occurrence of min1) and the
    exclusive sign from the parity of the negative edges."""
    if algo == "minsum":
        absq = torch.where(mask, torch.abs(q), _BIG)
        min1 = torch.amin(absq, dim=-1, keepdim=True)
        eq = absq == min1
        is_min = eq & (torch.cumsum(eq.to(torch.int32), dim=-1) == 1)
        min2 = torch.amin(torch.where(is_min, _BIG, absq), dim=-1,
                          keepdim=True)
        excl_min = torch.where(is_min, min2, min1)
        # the clip to the SPA's effective atanh bound keeps messages from
        # growing without bound through the graph's cycles
        excl_min = torch.clamp(alpha * torch.clamp(excl_min - beta, min=0.0),
                               0.0, 8.7)
        sbit = (mask & (q < 0)).to(torch.int32)
        par = torch.sum(sbit, dim=-1, keepdim=True)
        sign_excl = (1 - 2 * ((par - sbit) & 1)).to(q.dtype)
        return torch.where(mask, sign_excl * excl_min, 0.0)
    t = torch.where(mask, torch.tanh(0.5 * q), 1.0)
    ones = torch.ones_like(t[..., :1])
    fwd = torch.cat([ones, torch.cumprod(t, dim=-1)[..., :-1]], dim=-1)
    bwd = torch.cat([ones, torch.cumprod(t.flip(-1), dim=-1)[..., :-1]],
                    dim=-1).flip(-1)
    prod_excl = torch.clamp(fwd * bwd, -0.9999999, 0.9999999)
    return torch.where(mask, 2.0 * torch.atanh(prod_excl), 0.0)


def _check_var(code: LdpcCode) -> torch.Tensor:
    """[P, Cw] variables of each check, padded edges at the dummy slot N."""
    return torch.as_tensor(
        np.where(code.c_idx >= 0, code.c_idx, code.n).astype(np.int64))


def syndrome(llr: torch.Tensor, check_var: torch.Tensor) -> torch.Tensor:
    """Parity [B, P] (0/1) of each check over the hard decisions of llr."""
    bits = torch.cat([(llr < 0).long(),
                      torch.zeros_like(llr[:, :1], dtype=torch.long)], -1)
    return bits[:, check_var].sum(dim=-1) % 2


def _check_args(algo: str, rate_num: int, alpha: float | None):
    if algo not in ("spa", "minsum"):
        raise ValueError("algo must be 'spa' or 'minsum'")
    return float(MINSUM_ALPHA.get(rate_num, 0.75) if alpha is None else alpha)


# ---------------------------------------------------------------------------
# Decoders
# ---------------------------------------------------------------------------

class LayeredDecoder(nn.Module):
    """Layered belief propagation for one code rate, batched (the JAX
    decode_mm): the posterior is refreshed after each layer of checks.
    algo "spa" or "minsum" (alpha None: the rate's calibrated value; beta
    the min-sum offset); n_layers as in layer_plan.

    forward(llr [B, N], soft=False) -> (bits [B, N] int64, iters [B] int64,
    ok [B] bool), plus the posterior LLRs [B, N] float32 with soft=True
    (what BICM-ID reads)."""

    def __init__(self, rate_num: int, max_iter: int = 50, algo: str = "spa",
                 alpha: float | None = None, beta: float = 0.0,
                 n_layers: int | None = None):
        super().__init__()
        code = load_code(rate_num)
        self.n = code.n
        self.max_iter = int(max_iter)
        self.algo = algo
        self.alpha = _check_args(algo, rate_num, alpha)
        self.beta = float(beta)
        plan = layer_plan(rate_num, n_layers)
        n_l, pl, cw = plan.shape
        self.n_layers, self.pl, self.cw = n_l, pl, cw
        # padded edges read and write the dummy variable slot n
        self.register_buffer("edge_var", torch.as_tensor(
            np.where(plan >= 0, plan, code.n).reshape(n_l, pl * cw)),
            persistent=False)
        self.register_buffer("edge_mask", torch.as_tensor(plan >= 0),
                             persistent=False)
        self.register_buffer("check_var", _check_var(code), persistent=False)

    def syndrome_ok(self, llr: torch.Tensor) -> torch.Tensor:
        return torch.all(syndrome(llr, self.check_var) == 0, dim=-1)

    def _sweep(self, llr: torch.Tensor, r_msgs: list[torch.Tensor]):
        b = llr.shape[0]
        pad = torch.zeros_like(llr[:, :1])
        r_new_all = []
        for l in range(self.n_layers):
            idx = self.edge_var[l]
            r_old = r_msgs[l]
            post = torch.cat([_bf16(llr), pad], dim=-1)
            q = post[:, idx].reshape(b, self.pl, self.cw) - r_old
            r_new = check_node_update(q, self.edge_mask[l], self.algo,
                                      self.alpha, self.beta)
            delta = _bf16((r_new - r_old).reshape(b, -1))
            upd = torch.zeros((b, self.n + 1), dtype=llr.dtype,
                              device=llr.device).index_add_(1, idx, delta)
            llr = llr + upd[:, : self.n]
            r_new_all.append(r_new)
        return llr, r_new_all

    def forward(self, llr: torch.Tensor, soft: bool = False):
        llr = llr.to(torch.float32)
        b = llr.shape[0]
        done = self.syndrome_ok(llr)
        iters = torch.where(done, 0, self.max_iter + 1)
        r_msgs = [torch.zeros((b, self.pl, self.cw), dtype=torch.float32,
                              device=llr.device)
                  for _ in range(self.n_layers)]
        llr_tot = llr
        it = 0
        while it < self.max_iter and not bool(done.all()):
            llr_new, r_new = self._sweep(llr_tot, r_msgs)
            conv = self.syndrome_ok(llr_new)
            keep = done[:, None]
            llr_tot = torch.where(keep, llr_tot, llr_new)
            r_msgs = [torch.where(keep[:, :, None], r0, r1)
                      for r0, r1 in zip(r_msgs, r_new)]
            iters = torch.where(conv & ~done, it + 1, iters)
            done = done | conv
            it += 1
        bits = (llr_tot < 0).long()
        if soft:
            return bits, iters, done, llr_tot
        return bits, iters, done


class FloodingDecoder(nn.Module):
    """Flooding belief propagation for one code rate, batched (the JAX
    decode): every check updates from the previous iteration's messages.
    Messages live on the variable side as [B, N, Vw] slots; msg_dtype
    (None: float32, or torch.bfloat16) is their storage type, the check and
    variable arithmetic stays float32. forward(llr) -> (bits, iters, ok)."""

    def __init__(self, rate_num: int, max_iter: int = 50, algo: str = "spa",
                 alpha: float | None = None, beta: float = 0.0,
                 msg_dtype: torch.dtype | None = None):
        super().__init__()
        code = load_code(rate_num)
        n, vw = code.n, code.vw
        self.n, self.p, self.cw, self.vw = n, code.p, code.cw, vw
        self.max_iter = int(max_iter)
        self.algo = algo
        self.alpha = _check_args(algo, rate_num, alpha)
        self.beta = float(beta)
        self.msg_dtype = torch.float32 if msg_dtype is None else msg_dtype
        # each check edge's slot in the flat variable-side store [N*Vw];
        # padded edges read and write the trailing dummy slot N*Vw
        vpos = np.where(code.v_pos < 0, 0, code.v_pos)
        edge = np.where(code.c_idx >= 0, code.c_idx * vw + vpos, n * vw)
        self.register_buffer("edge_slot", torch.as_tensor(
            edge.reshape(-1).astype(np.int64)), persistent=False)
        self.register_buffer("c_mask", torch.as_tensor(code.c_idx >= 0),
                             persistent=False)
        self.register_buffer("v_mask", torch.as_tensor(code.v_idx >= 0),
                             persistent=False)
        self.register_buffer("check_var", _check_var(code), persistent=False)

    def syndrome_ok(self, llr: torch.Tensor) -> torch.Tensor:
        return torch.all(syndrome(llr, self.check_var) == 0, dim=-1)

    def forward(self, llr: torch.Tensor):
        llr = llr.to(torch.float32)
        b = llr.shape[0]
        n, vw, mdt = self.n, self.vw, self.msg_dtype
        done = self.syndrome_ok(llr)
        iters = torch.where(done, 0, self.max_iter + 1)
        q = torch.where(self.v_mask, llr[:, :, None], 0.0).to(mdt)
        llr_tot = llr
        pad = torch.zeros((b, 1), dtype=mdt, device=llr.device)
        it = 0
        while it < self.max_iter and not bool(done.all()):
            qf = torch.cat([q.reshape(b, n * vw), pad], dim=-1)
            qe = qf[:, self.edge_slot].reshape(b, self.p, self.cw).float()
            r_vals = check_node_update(qe, self.c_mask, self.algo, self.alpha,
                                       self.beta)
            r_flat = torch.zeros((b, n * vw + 1), dtype=mdt,
                                 device=llr.device)
            r_flat[:, self.edge_slot] = r_vals.reshape(b, -1).to(mdt)
            r_new = r_flat[:, : n * vw].reshape(b, n, vw).float()
            # summed slot by slot in order, as XLA reduces the axis: the
            # float32 sum is order-dependent and the rows that never
            # converge amplify a last-ulp difference
            r_in = torch.where(self.v_mask, r_new, 0.0)
            r_sum = r_in[..., 0]
            for k in range(1, vw):
                r_sum = r_sum + r_in[..., k]
            llr_new = llr + r_sum
            conv = self.syndrome_ok(llr_new)
            q_new = torch.where(self.v_mask, llr_new[:, :, None] - r_new,
                                0.0).to(mdt)
            q = torch.where(done[:, None, None], q, q_new)
            llr_tot = torch.where(done[:, None], llr_tot, llr_new)
            iters = torch.where(conv & ~done, it + 1, iters)
            done = done | conv
            it += 1
        return (llr_tot < 0).long(), iters, done


def decode_gbf(llr: torch.Tensor, rate_num: int, max_iter: int = 50,
               eta: float = 0.5):
    """Gradient bit-flipping (the JAX decode_gbf; reference
    ldpc_decoder_GBF.cc:25-120): each variable sums 2*syndrome-1 over its
    checks, and where that is positive its LLR moves toward a flip by eta
    times the sum. llr [B, N] -> (bits, iters, ok). Iterations count from 1:
    a row whose bits satisfy every check at the start of iteration it
    records iters = it."""
    code = load_code(rate_num)
    n = code.n
    dev = llr.device
    check_var = _check_var(code).to(dev)
    llr_t = llr.to(torch.float32)
    b = llr_t.shape[0]
    done = torch.all(syndrome(llr_t, check_var) == 0, dim=-1)
    iters = torch.where(done, 0, max_iter + 1)
    edge_var = check_var.reshape(-1)
    it = 1
    while it <= max_iter and not bool(done.all()):
        synd = syndrome(llr_t, check_var)
        conv = torch.all(synd == 0, dim=-1)
        contrib = (2 * synd - 1).to(torch.float32)
        delta = torch.zeros((b, n + 1), dtype=torch.float32,
                            device=dev).index_add_(
            1, edge_var, contrib.repeat_interleave(code.cw, dim=-1))[:, :n]
        step = ((delta > 0).long() * (2 * (llr_t < 0).long() - 1) * delta
                * eta)
        llr_t = torch.where((done | conv)[:, None], llr_t, llr_t + step)
        iters = torch.where(conv & ~done, it, iters)
        done = done | conv
        it += 1
    return (llr_t < 0).long(), iters, done
