"""Polar codes: butterfly encoding, successive-cancellation (SC) and SC-list
decoding (counterpart of ``srcdsp_tpu/polar.py``).

- Construction is on the host (the reference's numpy: Bhattacharyya
  recursion, the K most reliable synthetic channels carry data); the data
  positions are copied to the data's device per call, as the reference's
  numpy code is.
- Encoding is log2(N) butterfly stages of XOR over the whole batch.
- SC decoding is the textbook recursion over halves, unrolled in Python
  over a static tree (2N-1 nodes): f-nodes (min-sum box-plus), g-nodes
  (sign-adjusted sums), hard decisions masked by the frozen set. Every
  node works on the whole batch [B, size] at once (the reference vmaps one
  codeword).
- SC-list decoding carries the L paths as [B, L, size]. At each data leaf
  the paths fork to 2L candidates with the penalty |llr| for opposing the
  sign, and the best L survive by a STABLE argsort (the reference's
  `jnp.argsort` is stable; path metrics tie at the start, where the unused
  paths sit at F32_BIG). Each subtree returns the permutation from its
  output path order to its entry order; a frozen leaf returns None (the
  identity), so its parents skip the gathers.
- `polar_decode_list_onehot` keeps the reference's one-hot entry point (a
  TPU stand-in for gathers, bit-identical to them) and runs the gather form.

LLRs are positive for bit 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.types import F32, F32_BIG

__all__ = ["PolarCode", "make_polar", "polar_encode", "polar_decode",
           "polar_decode_list", "polar_decode_list_onehot"]

I32 = torch.int32


class PolarCode(NamedTuple):
    n: int
    k: int
    frozen: np.ndarray     # [N] bool, True = frozen (bit index order)
    data_pos: np.ndarray   # [K] i64 data positions (sorted)


def make_polar(n: int, k: int, design_z: float = 0.5) -> PolarCode:
    """Bhattacharyya-ranked construction: z_left = 2z - z^2, z_right = z^2
    down log2(N) levels; freeze the N - K least reliable channels."""
    if n & (n - 1) or n < 2:
        raise ValueError("N must be a power of two")
    if not 0 < k < n:
        raise ValueError("need 0 < K < N")
    z = np.asarray([design_z], np.float64)
    while z.size < n:
        z = np.concatenate([2 * z - z * z, z * z])
    # to decoder index order by bit reversal
    bits = n.bit_length() - 1
    br = np.zeros(n, np.int64)
    for i in range(n):
        v, r = i, 0
        for _ in range(bits):
            r = (r << 1) | (v & 1)
            v >>= 1
        br[i] = r
    z = z[br]
    order = np.argsort(z, kind="stable")          # most reliable first
    data_pos = np.sort(order[:k])
    frozen = np.ones(n, bool)
    frozen[data_pos] = False
    return PolarCode(n=int(n), k=int(k), frozen=frozen, data_pos=data_pos.astype(np.int64))


def _data_pos(code: PolarCode, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(code.data_pos, np.int64), device=device)


def polar_encode(code: PolarCode, u_info: torch.Tensor) -> torch.Tensor:
    """u_info [..., K] {0,1} -> codeword [..., N] int32 (butterfly transform)."""
    batch = tuple(u_info.shape[:-1])
    n = code.n
    x = torch.zeros(batch + (n,), dtype=I32, device=u_info.device)
    x[..., _data_pos(code, u_info.device)] = u_info.to(I32)
    half = 1
    while half < n:
        x = x.reshape(*batch, -1, 2, half)
        left = torch.bitwise_xor(x[..., 0, :], x[..., 1, :])
        x = torch.stack([left, x[..., 1, :]], dim=-2).reshape(*batch, n)
        half *= 2
    return x


def _f(a, b):
    """min-sum box-plus: sign(a)sign(b)min(|a|,|b|)."""
    return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())


def _g(a, b, u):
    """g-node: b + (1-2u) a for the already-decided left bits u."""
    return b + (1.0 - 2.0 * u) * a


def polar_decode(code: PolarCode, llr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Successive cancellation. llr [..., N] (positive favours bit 0).
    Returns (info bits [..., K] int32, u_hat [..., N] int32: every
    synthetic-channel decision, frozen zeros included)."""
    frozen = np.asarray(code.frozen)
    lead = tuple(llr.shape[:-1])
    l0 = llr.to(F32).reshape(-1, code.n)

    def sc(l, lo, size):
        """Subtree over bit indices [lo, lo+size) from its LLRs l [B, size]:
        (u decisions [B, size], partial sums x [B, size])."""
        if size == 1:
            u = torch.zeros_like(l, dtype=I32) if frozen[lo] else (l < 0).to(I32)
            return u, u
        half = size // 2
        a, b = l[:, :half], l[:, half:]
        u_l, x_l = sc(_f(a, b), lo, half)
        u_r, x_r = sc(_g(a, b, x_l.to(F32)), lo + half, half)
        return (torch.cat([u_l, u_r], dim=-1),
                torch.cat([torch.bitwise_xor(x_l, x_r), x_r], dim=-1))

    u_hat, _ = sc(l0, 0, code.n)
    info = u_hat[:, _data_pos(code, l0.device)]
    return info.reshape(lead + (code.k,)), u_hat.reshape(lead + (code.n,))


# ---------------------------------------------------------------------------
# SC-list, on gathers
# ---------------------------------------------------------------------------

def _rows(arr: torch.Tensor, perm: torch.Tensor | None) -> torch.Tensor:
    """arr [B, L, s] with its paths reordered by perm [B, L] (None: as is)."""
    if perm is None:
        return arr
    return torch.gather(arr, 1, perm[:, :, None].expand(-1, -1, arr.shape[-1]))


def _compose(p_l, p_r):
    """Output->entry permutation of a node from its children's (None = identity)."""
    if p_r is None:
        return p_l
    if p_l is None:
        return p_r
    return torch.gather(p_l, 1, p_r)


def _start(code: PolarCode, llr: torch.Tensor, lsz: int):
    l = llr.to(F32).reshape(-1, code.n)
    l0 = l[:, None, :].expand(-1, lsz, -1)
    pm0 = torch.full((l.shape[0], lsz), F32_BIG, dtype=F32, device=l.device)
    pm0[:, 0] = 0.0                                 # start from one path
    return l0, pm0


def _finish(code: PolarCode, lead, u_hat, pm):
    """(info, u_hat, pm) of paths already in best-first order, reshaped to `lead`."""
    info = u_hat[..., _data_pos(code, u_hat.device)]
    lsz = u_hat.shape[1]
    return (info.reshape(lead + (lsz, code.k)), u_hat.reshape(lead + (lsz, code.n)),
            pm.reshape(lead + (lsz,)))


def polar_decode_list(code: PolarCode, llr: torch.Tensor, list_size: int = 8
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Successive-cancellation LIST decoding. llr [..., N].

    Returns (info [..., L, K] int32, best path first; u_hat [..., L, N]
    int32; pm [..., L] float32 path metrics ascending). Pick row 0, or check
    the rows' CRCs in order for CRC-aided SCL.
    """
    lsz = int(list_size)
    if lsz < 1:
        raise ValueError(f"list_size must be >= 1, got {list_size}")
    frozen = np.asarray(code.frozen)
    lead = tuple(llr.shape[:-1])

    def leaf(l, pm, lo):
        """l [B, L, 1], pm [B, L] -> (u [B, L, 1], pm, perm [B, L] or None)."""
        lv = l[:, :, 0]
        pen = lv.abs()
        if frozen[lo]:
            # frozen: u = 0; paths whose llr prefers 1 pay the penalty
            return (torch.zeros_like(l, dtype=I32), pm + torch.where(lv < 0, pen, 0.0), None)
        # candidates: first L follow the sign, the next L oppose it
        follow = (lv < 0).to(I32)
        pm_cand = torch.cat([pm, pm + pen], dim=-1)                  # [B, 2L]
        order = torch.argsort(pm_cand, dim=-1, stable=True)[:, :lsz]
        perm = torch.remainder(order, lsz)                           # source path
        fp = torch.gather(follow, 1, perm)
        u_bit = torch.where(order < lsz, fp, 1 - fp)
        return u_bit[:, :, None], torch.gather(pm_cand, 1, order), perm

    def dec(l, pm, lo, size):
        if size == 1:
            u, pm2, perm = leaf(l, pm, lo)
            return u, u, pm2, perm
        half = size // 2
        a, b = l[..., :half], l[..., half:]
        u_l, x_l, pm, perm_l = dec(_f(a, b), pm, lo, half)
        a2, b2 = _rows(a, perm_l), _rows(b, perm_l)                  # remap cached LLRs
        u_r, x_r, pm, perm_r = dec(_g(a2, b2, x_l.to(F32)), pm, lo + half, half)
        x_l = _rows(x_l, perm_r)
        u = torch.cat([_rows(u_l, perm_r), u_r], dim=-1)
        x = torch.cat([torch.bitwise_xor(x_l, x_r), x_r], dim=-1)
        return u, x, pm, _compose(perm_l, perm_r)

    l0, pm0 = _start(code, llr, lsz)
    u_hat, _, pm, _ = dec(l0, pm0, 0, code.n)
    order = torch.argsort(pm, dim=-1, stable=True)
    return _finish(code, lead, _rows(u_hat, order), torch.gather(pm, 1, order))


def polar_decode_list_onehot(code: PolarCode, llr: torch.Tensor, list_size: int = 8,
                             fast: bool = False
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's one-hot SC-list entry point, kept for API parity: the
    one-hot matrices there stand in for gathers on its TPU, and its outputs
    equal the gather form's bit for bit. Here it is `polar_decode_list`
    itself; `fast` (the reference's rate-0/REP shortcut, also bit-identical)
    has no effect on this backend."""
    del fast
    return polar_decode_list(code, llr, list_size)
