"""Binary BCH codec over GF(2^m) (counterpart of ``srcdsp_tpu/bch.py``):
n = 2^m - 1 bits, t bit errors corrected (POCSAG's (31, 21), t = 2).

The same mapping as `rs`: encode (parity m(x) x^{n-k} mod g(x)) and the
syndromes are float32 bit matmuls mod 2 (TF32 pinned off), batched over
codewords; Berlekamp-Massey and the Chien search are `rs`'s, over
GF(2^m). Binary BCH needs no Forney step: error values are 1, so the
correction is an XOR at the located bits. The corrected word is
re-syndromed, and a word that is still not a codeword is flagged
ok=False.

Shortening: pass `shorten=` to encode and decode; positions keep their
polynomial powers (implicit zero prefix), and decode rejects words whose
corrections land in that prefix.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.rs import berlekamp_massey, code_tensors, poly_eval, gf2_matmul
from srcdsp_tpu_torch.types import F32

__all__ = ["BchCode", "make_bch_code", "bch_encode", "bch_decode"]

# standard primitive polynomials per field degree m
_PRIMS = {3: 0xB, 4: 0x13, 5: 0x25, 6: 0x43, 7: 0x89, 8: 0x11D, 9: 0x211, 10: 0x409}


def _build_tables(m: int):
    prim = _PRIMS[m]
    n = (1 << m) - 1
    exp = np.zeros(2 * n, np.int32)
    log = np.zeros(n + 1, np.int32)
    x = 1
    for i in range(n):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & (1 << m):
            x ^= prim
    exp[n: 2 * n] = exp[:n]
    return exp, log


def _minimal_poly(s: int, m: int, exp, log) -> np.ndarray:
    """Minimal polynomial of alpha^s over GF(2), MSB first as 0/1 ints."""
    n = (1 << m) - 1
    conj = []
    c = s % n
    while c not in conj:
        conj.append(c)
        c = (c * 2) % n

    def gf_mul(a, b):
        if a == 0 or b == 0:
            return 0
        return int(exp[(log[a] + log[b]) % n])

    poly = [1]
    for c in conj:
        root = int(exp[c])
        nxt = [0] * (len(poly) + 1)
        for i, pc in enumerate(poly):
            nxt[i] ^= gf_mul(pc, 1)
            nxt[i + 1] ^= gf_mul(pc, root)
        poly = nxt
    assert all(pc in (0, 1) for pc in poly), "minimal poly not binary"
    return np.asarray(poly, np.int64)


def _poly_mul_gf2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a) + len(b) - 1, np.int64)
    for i, ai in enumerate(a):
        if ai:
            out[i: i + len(b)] ^= b
    return out % 2


class BchCode(NamedTuple):
    n: int
    k: int
    t: int
    m: int
    gen: np.ndarray            # [n-k+1] generator bits, MSB first (host)
    enc_bits: torch.Tensor     # [k, n-k] float32 parity matrix
    syn_bits: torch.Tensor     # [n, 2t*m] float32 syndrome matrix
    exp: torch.Tensor          # [2(2^m-1)] int64 GF tables
    log: torch.Tensor
    chien_pow: torch.Tensor    # [n, t+1] int64 exponents for the Chien search


def bch_tables(m: int, t: int) -> dict:
    """The host (numpy) tables of the primitive BCH code: the reference's construction."""
    exp_np, log_np = _build_tables(m)
    n = (1 << m) - 1
    g = np.asarray([1], np.int64)
    seen = set()
    for s in range(1, 2 * t + 1):
        cls = frozenset(((s % n) * (1 << j)) % n for j in range(m))
        if cls in seen:
            continue
        seen.add(cls)
        g = _poly_mul_gf2(g, _minimal_poly(s, m, exp_np, log_np))
    r = len(g) - 1
    k = n - r
    if k <= 0:
        raise ValueError(f"t={t} too large for m={m}")

    def x_mod_g(power: int) -> np.ndarray:
        rem = np.zeros(power + 1, np.int64)
        rem[0] = 1
        for i in range(len(rem) - r):
            if rem[i]:
                rem[i: i + r + 1] ^= g
        return rem[-r:] % 2

    enc = np.stack([x_mod_g(n - 1 - i) for i in range(k)])
    syn = np.zeros((n, 2 * t * m), np.int64)
    for i in range(n):
        p = n - 1 - i
        for j in range(1, 2 * t + 1):
            v = int(exp_np[(j * p) % n])
            for b in range(m):
                syn[i, (j - 1) * m + b] = (v >> (m - 1 - b)) & 1
    pw = np.asarray([n - 1 - i for i in range(n)])
    chien = np.stack([(-pw * j) % n for j in range(t + 1)], axis=1)
    return dict(n=n, k=k, t=t, m=m, gen=g.astype(np.int64), enc_bits=enc, syn_bits=syn,
                exp=exp_np, log=log_np, chien_pow=chien)


def make_bch_code(m: int, t: int, device=None) -> BchCode:
    """Primitive binary BCH, n = 2^m - 1, correcting t errors; k falls out of
    deg(g): (m=5, t=2) -> (31, 21), (m=6, t=3) -> (63, 45). Tables on
    `device` (the card unless it says otherwise)."""
    return code_tensors(bch_tables(m, t), BchCode, ("enc_bits", "syn_bits"), device,
                        host_keys=("gen",))


def bch_encode(code: BchCode, msg: torch.Tensor, shorten: int = 0) -> torch.Tensor:
    """msg [B, k - shorten] {0,1} -> codewords [B, n - shorten] int32
    (systematic: message bits then parity)."""
    if shorten:
        if not 0 < shorten < code.k:
            raise ValueError(f"shorten must be in [0, k), got {shorten}")
        z = torch.zeros((*msg.shape[:-1], shorten), dtype=msg.dtype, device=msg.device)
        msg = torch.cat([z, msg], dim=-1)
    par = gf2_matmul(msg.to(F32), code.enc_bits)
    out = torch.cat([msg.to(torch.int32), par.to(torch.int32)], dim=-1)
    return out[..., shorten:] if shorten else out


def _syndromes(code: BchCode, recv: torch.Tensor) -> torch.Tensor:
    sb = gf2_matmul(recv.to(F32), code.syn_bits).to(torch.int64)
    sb = sb.reshape(*sb.shape[:-1], 2 * code.t, code.m)
    w = torch.arange(code.m - 1, -1, -1, device=recv.device)
    return (sb << w).sum(dim=-1)                       # [B, 2t] field elements


def bch_decode(code: BchCode, recv: torch.Tensor, shorten: int = 0):
    """recv [B, n - shorten] {0,1} -> (msg [B, k - shorten] int32, ok [B]
    bool). Corrects up to t bit errors; ok=False marks words that still fail
    the syndrome check or (shortened) whose corrections land in the prefix."""
    k, t = code.k, code.t
    recv = recv.to(torch.int32)
    if shorten:
        if not 0 < shorten < code.k:
            raise ValueError(f"shorten must be in [0, k), got {shorten}")
        z = torch.zeros((*recv.shape[:-1], shorten), dtype=recv.dtype, device=recv.device)
        recv = torch.cat([z, recv], dim=-1)
    s = _syndromes(code, recv)
    clean = (s == 0).all(dim=-1)
    lam, _ = berlekamp_massey(s, t, code.exp, code.log, code.n, code.m)
    evals = poly_eval(lam, code.chien_pow, code.exp, code.log, code.n,
                      [(j, j) for j in range(t + 1)])
    errs = (evals == 0).to(torch.int32)                # binary: the value is 1
    corrected = torch.where(clean[:, None], recv, torch.bitwise_xor(recv, errs))
    ok = (_syndromes(code, corrected) == 0).all(dim=-1)
    if shorten:
        ok = ok & (corrected[:, :shorten] == 0).all(dim=-1)
        return corrected[:, shorten:k], ok
    return corrected[:, :k], ok
