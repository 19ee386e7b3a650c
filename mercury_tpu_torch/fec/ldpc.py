"""LDPC encode and layered sum-product decode (PyTorch port of the JAX
package's `fec/ldpc.py`: `encode` and `decode_mm` in its default layered
SPA schedule).

The JAX decoder moves messages with one-hot incidence matmuls whose data
operand is bfloat16. Here the same moves are a gather and a scatter-add, and
the data side is rounded to bfloat16 at exactly the points where the JAX
matmuls round it: the posterior read into the check update, and the
posterior delta written back. The syndrome is an integer parity count.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from mercury_tpu_torch.fec.tables import LdpcCode, load_code


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
def layer_plan(rate_num: int) -> np.ndarray:
    """[L, Pl, Cw] check -> variable indices (-1 pad) of the smallest
    balanced variable-disjoint layering (searched from the maximum variable
    degree upward)."""
    code = load_code(rate_num)
    p, cw = code.p, code.cw
    for n_layers in range(int(code.deg.max()), p + 1):
        members = _assign_layers(code.c_idx, n_layers)
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
# Decoder
# ---------------------------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to bfloat16 and back (round to nearest even)."""
    return x.to(torch.bfloat16).to(torch.float32)


def check_node_update(q: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """SPA check update on edge messages q [B, Pl, Cw] (mask [Pl, Cw]):
    R = 2 atanh(prod_{other edges} tanh(q/2)), exclusive products from
    forward/backward cumulative products; 0 on padded edges."""
    t = torch.where(mask, torch.tanh(0.5 * q), 1.0)
    ones = torch.ones_like(t[..., :1])
    fwd = torch.cat([ones, torch.cumprod(t, dim=-1)[..., :-1]], dim=-1)
    bwd = torch.cat([ones, torch.cumprod(t.flip(-1), dim=-1)[..., :-1]],
                    dim=-1).flip(-1)
    prod_excl = torch.clamp(fwd * bwd, -0.9999999, 0.9999999)
    return torch.where(mask, 2.0 * torch.atanh(prod_excl), 0.0)


class LayeredDecoder(nn.Module):
    """Layered SPA belief propagation for one code rate, batched.

    forward(llr [B, N]) -> (bits [B, N] int64, iters [B] int64, ok [B] bool)
    with the JAX decode_mm contract: iters 0 for a row whose hard decisions
    already satisfy every check, the sweep count at convergence otherwise,
    and max_iter+1 for a row that never converges. Converged rows are frozen;
    the loop ends when every row is done or after max_iter sweeps (one
    host-side read of the done mask per sweep)."""

    def __init__(self, rate_num: int, max_iter: int = 50):
        super().__init__()
        code = load_code(rate_num)
        self.n = code.n
        self.max_iter = int(max_iter)
        plan = layer_plan(rate_num)
        n_layers, pl, cw = plan.shape
        self.n_layers, self.pl, self.cw = n_layers, pl, cw
        # padded edges read and write the dummy variable slot n
        self.register_buffer("edge_var", torch.as_tensor(
            np.where(plan >= 0, plan, code.n).reshape(n_layers, pl * cw)),
            persistent=False)
        self.register_buffer("edge_mask", torch.as_tensor(plan >= 0),
                             persistent=False)
        self.register_buffer("check_var", torch.as_tensor(
            np.where(code.c_idx >= 0, code.c_idx, code.n).astype(np.int64)),
            persistent=False)

    def syndrome_ok(self, llr: torch.Tensor) -> torch.Tensor:
        bits = torch.cat([(llr < 0).long(),
                          torch.zeros_like(llr[:, :1], dtype=torch.long)], -1)
        cnt = bits[:, self.check_var].sum(dim=-1)                  # [B, P]
        return torch.all(cnt % 2 == 0, dim=-1)

    def _sweep(self, llr: torch.Tensor, r_msgs: list[torch.Tensor]):
        b = llr.shape[0]
        pad = torch.zeros_like(llr[:, :1])
        r_new_all = []
        for l in range(self.n_layers):
            idx = self.edge_var[l]
            r_old = r_msgs[l]
            post = torch.cat([_bf16(llr), pad], dim=-1)
            q = post[:, idx].reshape(b, self.pl, self.cw) - r_old
            r_new = check_node_update(q, self.edge_mask[l])
            delta = _bf16((r_new - r_old).reshape(b, -1))
            upd = torch.zeros((b, self.n + 1), dtype=llr.dtype,
                              device=llr.device).index_add_(1, idx, delta)
            llr = llr + upd[:, : self.n]
            r_new_all.append(r_new)
        return llr, r_new_all

    def forward(self, llr: torch.Tensor):
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
        return (llr_tot < 0).long(), iters, done
