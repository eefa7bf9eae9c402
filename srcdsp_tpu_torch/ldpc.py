"""LDPC codec: GF(2) encoding and dense normalized min-sum decoding
(counterpart of ``srcdsp_tpu/ldpc.py``).

- **Code construction is host-side numpy** (design time), a copy of the
  reference's: a deterministic Gallager-style regular (dv, dc) parity-check
  matrix with degree-preserving 4-cycle reduction, then GF(2) elimination to a
  systematic generator. From the same seed H, ``gp`` and ``col_perm`` come out
  equal element for element.
- **Encoding is one matmul mod 2**: parity = u @ gp mod 2. The sums reach K
  (1024 at the serving code), exact in float32 but not in TF32 or bf16, so
  the product runs in float32 with TF32 off (`ops.fir.pin_f32`). The same
  holds for every syndrome bits @ H^T mod 2.
- **Decoding is dense masked min-sum** on [..., M, N] messages, a fixed
  iteration count and a syndrome flag instead of an early exit. The serving
  decoders are the kernels in ``kernels/ldpc_pallas.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import F32

BIG = np.float32(1e30)   # finite mask magnitude (the reference's F32_BIG)


class LdpcCode(NamedTuple):
    """Static code description, as tensors on one device.

    h: [M, N] float32 {0,1} parity-check mask (dense).
    gp: [K, M] float32 {0,1} parity part of the systematic generator:
        parity = (u @ gp) mod 2, codeword = [parity | u] in systematic order.
    col_perm: [N] int64 mapping H's column order to the systematic order
        (codeword c[j] = sys[col_perm[j]]).
    n, k: code dimensions.
    """

    h: torch.Tensor
    gp: torch.Tensor
    col_perm: torch.Tensor
    n: int
    k: int


# ---------------------------------------------------------------------------
# Host-side construction (design time; the reference's numpy, unchanged)
# ---------------------------------------------------------------------------

def make_regular_ldpc(n: int, dv: int = 3, dc: int = 6, seed: int = 0) -> np.ndarray:
    """Deterministic Gallager-style regular LDPC parity-check matrix [m, n]
    uint8, m = n*dv/dc: dv stacked permuted bands, then degree-preserving
    edge swaps until no column pair shares more than one check."""
    if n % dc != 0:
        raise ValueError(f"n={n} not divisible by dc={dc}")
    rng = np.random.default_rng(seed)
    rows_per_band = n // dc
    m = dv * rows_per_band
    band = np.zeros((rows_per_band, n), dtype=np.uint8)
    for r in range(rows_per_band):
        band[r, r * dc:(r + 1) * dc] = 1
    blocks = [band[:, rng.permutation(n)] for _ in range(dv)]
    h = np.concatenate(blocks, axis=0)

    for _ in range(200):
        gram = (h.astype(np.int32).T @ h.astype(np.int32))
        np.fill_diagonal(gram, 0)
        bad = np.argwhere(np.triu(gram) > 1)
        if bad.size == 0:
            break
        for c1, c2 in bad:
            shared = np.flatnonzero(h[:, c1] & h[:, c2])
            if shared.size <= 1:
                continue
            r = shared[rng.integers(shared.size)]
            for _attempt in range(30):
                r2 = int(rng.integers(m))
                cols3 = np.flatnonzero(h[r2])
                c3 = int(cols3[rng.integers(cols3.size)])
                if r2 != r and c3 != c2 and h[r, c3] == 0 and h[r2, c2] == 0:
                    h[r, c2] = 0
                    h[r, c3] = 1
                    h[r2, c3] = 0
                    h[r2, c2] = 1
                    break
    return h


def _gf2_systematize(h: np.ndarray):
    """Row-reduce H over GF(2) to [I_M | P] up to a column permutation.

    Returns (h_reduced [Mr, N], perm [N] with h_sys = h_rref[:, perm], rank
    Mr); dependent rows are dropped.
    """
    h = h.copy().astype(np.uint8)
    m, n = h.shape
    perm = list(range(n))
    row = 0
    for col in range(n):
        if row >= m:
            break
        found = False
        for cc in range(col, n):
            piv = np.flatnonzero(h[row:, perm[cc]])
            if piv.size:
                perm[col], perm[cc] = perm[cc], perm[col]
                found = True
                break
        if not found:
            break
        p = row + piv[0]
        if p != row:
            h[[row, p]] = h[[p, row]]
        c = perm[col]
        elim = np.flatnonzero(h[:, c])
        elim = elim[elim != row]
        h[elim] ^= h[row]
        row += 1
    rank = row
    return h[:rank], np.array(perm, dtype=np.int64), rank


def make_ldpc_code(h: np.ndarray, device=None) -> LdpcCode:
    """The codec of a parity-check matrix [M, N] of {0,1}: a systematic
    generator by GF(2) elimination (info bits in the last K permuted
    columns), `col_perm` restoring H's column order."""
    device = resolve(device)
    h = np.asarray(h, dtype=np.uint8)
    hr, perm, rank = _gf2_systematize(h)
    _, n = hr.shape
    k = n - rank
    if k <= 0:
        raise ValueError("H has full column rank: code has no info bits")
    gp = hr[:, perm[rank:]].T.astype(np.float32)         # [K, rank]
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    return LdpcCode(h=torch.as_tensor(h.astype(np.float32), device=device),
                    gp=torch.as_tensor(gp, device=device),
                    col_perm=torch.as_tensor(inv, device=device), n=int(n), k=int(k))


def info_index(code: LdpcCode) -> torch.Tensor:
    """Native column of each info bit: the last K systematic slots."""
    return torch.argsort(code.col_perm)[code.n - code.k:]


def syndrome_ok(bits: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """bits [..., N] int -> [...] bool, every check of H [M, N] satisfied
    (one float32 product mod 2, TF32 off)."""
    pin_f32(bits)
    syn = torch.remainder(bits.to(F32) @ h.T, 2.0)
    return torch.all(syn == 0, dim=-1)


# ---------------------------------------------------------------------------
# Encode / decode
# ---------------------------------------------------------------------------

def ldpc_encode(code: LdpcCode, u) -> torch.Tensor:
    """Encode info bits [..., K] of {0,1} -> codewords [..., N] int32 in H's
    column order."""
    u = torch.as_tensor(u, device=code.gp.device)
    pin_f32(u)
    uf = u.to(F32)
    par = torch.remainder(uf @ code.gp, 2.0)
    sys = torch.cat([par, uf], dim=-1)
    return sys[..., code.col_perm].to(torch.int32)


def minsum_c2v(h: torch.Tensor, v2c: torch.Tensor, alpha: float) -> torch.Tensor:
    """Normalized min-sum check update on dense masked messages [..., M, N]
    (zeros off the support of h): per edge, alpha * the product of the other
    signs * the least other magnitude (min2 on the argmin edge, min1 on the
    rest; equal minima leave min1 everywhere)."""
    big = torch.tensor(BIG, dtype=F32, device=v2c.device)
    mag = torch.where(h > 0, torch.abs(v2c), big)
    sgn = torch.where(v2c < 0, -1.0, 1.0).to(F32)
    row_sgn = torch.prod(torch.where(h > 0, sgn, 1.0), dim=-1, keepdim=True)
    min1 = torch.amin(mag, dim=-1, keepdim=True)
    is_min = mag == min1
    dup = torch.sum(is_min.to(F32), dim=-1, keepdim=True) > 1.5
    min_excl = torch.amin(torch.where(is_min, big, mag), dim=-1, keepdim=True)
    min2 = torch.where(dup, min1, min_excl)
    emag = torch.where(is_min, min2, min1)
    emag = torch.where(emag >= big, 0.0, emag)
    return np.float32(alpha) * row_sgn * sgn * emag * h


def ldpc_decode(code: LdpcCode, llr: torch.Tensor, iters: int = 25, alpha: float = 0.8125):
    """Flooding normalized min-sum. llr [..., N], > 0 favouring bit 0.

    Returns (bits [..., N] int32, info [..., K] int32, ok [...] bool), ok when
    every check holds after `iters` iterations.
    """
    h = code.h
    lf = llr.to(F32)
    msg = torch.zeros((*lf.shape[:-1], *h.shape), dtype=F32, device=lf.device)
    for _ in range(iters):
        tot = lf[..., None, :] + torch.sum(msg, dim=-2, keepdim=True)
        msg = minsum_c2v(h, (tot - msg) * h, alpha)
    post = lf + torch.sum(msg, dim=-2)
    bits = (post < 0).to(torch.int32)
    return bits, bits[..., info_index(code)], syndrome_ok(bits, h)
