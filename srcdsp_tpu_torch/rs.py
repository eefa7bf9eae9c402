"""Reed-Solomon codec over GF(256) (counterpart of ``srcdsp_tpu/rs.py``).

Every GF(256)-linear map is GF(2)-linear on the bits, so the two bulk
stages are float32 matmuls mod 2 (exact: 0/1 entries, sums below 2^24;
TF32 pinned off), batched over codewords:

- encode: the systematic parity m(x) x^2t mod g(x), one [B, 8k] @ [8k, 16t];
- syndromes: S_j = r(alpha^j), one [B, 8n] @ [8n, 16t] (re-run on the
  corrected word to certify it).

Berlekamp-Massey is a loop over the 2t syndromes with where-selected
updates only (no branch on the data), batched over codewords. GF products
go through the exp/log tables (exp has 510 entries, so log a + log b stays
in range). torch has no XOR reduction, so the discrepancy XOR-reduces bit
planes with a sum mod 2; the Chien search, Omega (one term of Lambda at a
time over all of S, not one scalar update per pair) and Forney's formula
loop over the polynomial terms, each step over all positions and codewords.

Shortened codes (n < 255) index positions by their polynomial power
n-1-i, so they use the same tables.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.gf2 import byte_tensor_bits
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import F32

__all__ = ["RsCode", "make_rs_code", "rs_encode", "rs_decode"]

_PRIM = 0x11D  # x^8+x^4+x^3+x^2+1 (CCSDS/DVB primitive polynomial)


def _build_tables(prim: int = _PRIM):
    exp = np.zeros(510, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= prim
    exp[255:510] = exp[0:255]
    return exp, log


_EXP, _LOG = _build_tables()


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def _gf_mul_bitmat(c: int) -> np.ndarray:
    """[8, 8] GF(2) matrix of multiply-by-c: row b = bits of c * x^b (LSB first)."""
    m = np.zeros((8, 8), np.uint8)
    for b in range(8):
        prod = _gf_mul(c, 1 << b)
        m[b] = [(prod >> j) & 1 for j in range(8)]
    return m


def _poly_mod_g(num: np.ndarray, g: np.ndarray) -> np.ndarray:
    """num(x) mod g(x), coefficient arrays highest-power-first."""
    num = num.copy()
    dg = g.size - 1
    for i in range(num.size - dg):
        c = int(num[i])
        if c:
            for j in range(g.size):
                num[i + j] ^= _gf_mul(c, int(g[j]))
    return num[-dg:]


class RsCode(NamedTuple):
    n: int
    k: int
    t: int
    enc_bits: torch.Tensor    # [8k, 16t] float32 GF(2) encode matrix
    syn_bits: torch.Tensor    # [8n, 16t] float32 GF(2) syndrome matrix
    exp: torch.Tensor         # [510] int64 GF exp table
    log: torch.Tensor         # [256] int64 GF log table
    chien_pow: torch.Tensor   # [n, t+1] int64 exponents of alpha^{-(n-1-i)j} mod 255
    forney_pow: torch.Tensor  # [n, 2t] int64 exponents for Omega's evaluation


def rs_tables(n: int, k: int) -> dict:
    """The host (numpy) tables of RS(n, k): the reference's construction."""
    if not (2 <= k < n <= 255) or (n - k) % 2:
        raise ValueError(f"need 2 <= k < n <= 255 with n-k even, got {n},{k}")
    t = (n - k) // 2
    p = 2 * t
    g = np.array([1], np.int32)                 # prod_{j=1..2t} (x - alpha^j)
    for j in range(1, p + 1):
        root = int(_EXP[j])
        nxt = np.zeros(g.size + 1, np.int32)
        for i, c in enumerate(g):
            nxt[i] ^= _gf_mul(int(c), 1)
            nxt[i + 1] ^= _gf_mul(int(c), root)
        g = nxt
    enc = np.zeros((8 * k, 8 * p), np.uint8)    # m_i * (x^{n-1-i} mod g)
    for i in range(k):
        num = np.zeros(n - i, np.int32)
        num[0] = 1
        r = _poly_mod_g(num, g)
        for j in range(p):
            enc[8 * i: 8 * i + 8, 8 * j: 8 * j + 8] = _gf_mul_bitmat(int(r[j]))
    syn = np.zeros((8 * n, 8 * p), np.uint8)    # S_j = sum_i r_i alpha^{(j+1)(n-1-i)}
    for i in range(n):
        pw = n - 1 - i
        for j in range(p):
            syn[8 * i: 8 * i + 8, 8 * j: 8 * j + 8] = _gf_mul_bitmat(int(_EXP[((j + 1) * pw) % 255]))
    ii = np.arange(n)[:, None]
    chien = (-(np.arange(t + 1)[None, :] * (n - 1 - ii))) % 255
    forney = (-(np.arange(p)[None, :] * (n - 1 - ii))) % 255
    return dict(n=n, k=k, t=t, enc_bits=enc, syn_bits=syn, exp=_EXP, log=_LOG,
                chien_pow=chien, forney_pow=forney)


def code_tensors(tabs: dict, cls, float_keys, device, host_keys=()):
    """`cls` from host tables: float_keys as float32, other arrays int64, on
    `device`; host_keys stay numpy."""
    device = resolve(device)

    def conv(key, v):
        if not isinstance(v, np.ndarray) or key in host_keys:
            return v
        dtype = np.float32 if key in float_keys else np.int64
        return torch.as_tensor(np.array(v, dtype), device=device)

    return cls(**{f: conv(f, tabs[f]) for f in cls._fields})


def make_rs_code(n: int = 255, k: int = 223, device=None) -> RsCode:
    """RS(n, k) over GF(256), narrow-sense (roots alpha^1..alpha^2t), t =
    (n-k)//2, tables on `device` (the card unless it says otherwise)."""
    return code_tensors(rs_tables(n, k), RsCode, ("enc_bits", "syn_bits"), device)


def _bytes_to_bits(x: torch.Tensor) -> torch.Tensor:
    """[..., S] bytes -> [..., 8S] float32 bits, LSB first per byte."""
    return byte_tensor_bits(x, lsb_first=True).to(F32)


def _bits_to_bytes(b: torch.Tensor) -> torch.Tensor:
    """[..., 8S] {0,1} -> [..., S] int64, LSB first per byte."""
    bb = b.reshape(*b.shape[:-1], -1, 8).to(torch.int64)
    return (bb << torch.arange(8, device=b.device)).sum(dim=-1)


def gf2_matmul(bits: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    pin_f32(bits)
    return torch.remainder(bits @ mat, 2.0)


def rs_encode(code: RsCode, msg: torch.Tensor) -> torch.Tensor:
    """Systematic encode. msg [B, k] bytes -> codeword [B, n] uint8
    (message symbols first, then 2t parity symbols). One matmul."""
    pbits = gf2_matmul(_bytes_to_bits(msg), code.enc_bits)
    return torch.cat([msg.to(torch.uint8), _bits_to_bytes(pbits).to(torch.uint8)], dim=-1)


def _syndromes(code: RsCode, recv: torch.Tensor) -> torch.Tensor:
    return _bits_to_bytes(gf2_matmul(_bytes_to_bits(recv), code.syn_bits))   # [B, 2t]


def gf_mul(exp: torch.Tensor, log: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GF product through the tables (0-safe; exp holds two periods)."""
    return torch.where((a == 0) | (b == 0), 0, exp[log[a] + log[b]])


def xor_reduce(x: torch.Tensor, bits: int) -> torch.Tensor:
    """XOR over the last axis of non-negative ints below 2^bits: each bit
    plane summed mod 2."""
    sh = torch.arange(bits, device=x.device)
    par = ((x[..., None] >> sh) & 1).sum(dim=-2) & 1
    return (par << sh).sum(dim=-1)


def berlekamp_massey(s: torch.Tensor, t: int, exp: torch.Tensor, log: torch.Tensor,
                     nn: int, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Berlekamp-Massey over syndromes s [B, 2t] (GF(2^bits), nn = 2^bits - 1)
    -> (Lambda [B, t+1], L [B]), one step per syndrome, updates by select."""
    b_dim, p = s.shape
    tp1 = t + 1
    dev = s.device
    idx = torch.arange(tp1, device=dev)
    lam = torch.zeros((b_dim, tp1), dtype=torch.int64, device=dev)
    lam[:, 0] = 1
    bpoly = lam.clone()
    ll = torch.zeros(b_dim, dtype=torch.int64, device=dev)
    mm = torch.ones_like(ll)
    bb = torch.ones_like(ll)
    back = torch.arange(p, device=dev)[:, None] - idx                 # [2t, t+1]: r - j
    for r in range(p):
        sj = torch.where(back[r] >= 0, s[:, back[r].clamp(0, p - 1)], 0)
        d = xor_reduce(gf_mul(exp, log, lam, sj), bits)          # discrepancy
        coef = torch.where(d == 0, 0, exp[torch.remainder(log[d] - log[bb], nn)])
        sh = idx - mm[:, None]                                    # x^m * B(x)
        shifted = torch.where(sh >= 0, bpoly.gather(1, sh.clamp(0, tp1 - 1)), 0)
        lam_new = torch.bitwise_xor(lam, gf_mul(exp, log, shifted, coef[:, None]))
        upd = d != 0
        grow = upd & (2 * ll <= r)
        bpoly = torch.where(grow[:, None], lam, bpoly)
        lam = torch.where(upd[:, None], lam_new, lam)
        ll = torch.where(grow, r + 1 - ll, ll)
        bb = torch.where(grow, d, bb)
        mm = torch.where(grow, 1, mm + 1)
    return lam, ll


def poly_eval(coef: torch.Tensor, pows: torch.Tensor, exp: torch.Tensor, log: torch.Tensor,
              nn: int, terms) -> torch.Tensor:
    """XOR over j in `terms` of coef[:, j] * alpha^pows[:, col(j)] at every
    position: coef [B, J] field elements, pows [n, J'] exponents; `terms`
    is a list of (j, col) pairs. Returns [B, n]."""
    logc = log[coef]
    acc = torch.zeros((coef.shape[0], pows.shape[0]), dtype=torch.int64, device=coef.device)
    for j, col in terms:
        term = exp[torch.remainder(logc[:, j, None] + pows[None, :, col], nn)]
        acc = torch.bitwise_xor(acc, torch.where(coef[:, j, None] == 0, 0, term))
    return acc


def rs_decode(code: RsCode, recv: torch.Tensor):
    """Decode recv [B, n] bytes -> (msg [B, k] uint8, ok [B] bool).

    Corrects up to t symbol errors per codeword; ok=False flags blocks whose
    corrected word still fails the syndrome check."""
    t = code.t
    p = 2 * t
    exp, log = code.exp, code.log
    recv = recv.to(torch.uint8)
    s = _syndromes(code, recv)                                    # [B, 2t]
    clean = (s == 0).all(dim=-1)
    lam, _ = berlekamp_massey(s, t, exp, log, 255, 8)

    # Chien search: Lambda(alpha^{-(n-1-i)}) == 0 marks an error at i
    is_err = poly_eval(lam, code.chien_pow, exp, log, 255,
                       [(j, j) for j in range(t + 1)]) == 0
    # Omega(x) = S(x) Lambda(x) mod x^2t, one term of Lambda at a time
    om = torch.zeros_like(s)
    for j in range(t + 1):
        om[:, j:] = torch.bitwise_xor(om[:, j:], gf_mul(exp, log, lam[:, j:j + 1], s[:, :p - j]))
    # Forney (fcr = 1): e_i = Omega(X_i^-1) / Lambda'(X_i^-1),
    # Lambda'(x) = sum_{j odd} lam_j x^{j-1}
    num = poly_eval(om, code.forney_pow, exp, log, 255, [(j, j) for j in range(p)])
    den = poly_eval(lam, code.chien_pow, exp, log, 255, [(j, j - 1) for j in range(1, t + 1, 2)])
    ev = exp[torch.remainder(log[num] - log[den], 255)]
    ev = torch.where((num == 0) | (den == 0), 0, ev)
    errs = torch.where(is_err, ev, 0).to(torch.uint8)
    corrected = torch.where(clean[:, None], recv, torch.bitwise_xor(recv, errs))
    ok = (_syndromes(code, corrected) == 0).all(dim=-1)
    return corrected[:, : code.k], ok
