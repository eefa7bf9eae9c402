"""Quasi-cyclic LDPC + layered min-sum (counterpart of ``srcdsp_tpu/qcldpc.py``).

H is an [Mb, Nb] protograph of Z x Z circulant blocks (shift s, or -1 for a
zero block). Construction (`make_qc_base`, `qc_expand`, `make_qc_ldpc`,
`make_dual_diagonal_base`, `load_qc_table`) is the reference's host numpy,
so the same seed gives the same base matrix and H. `qc_encode_dual_diagonal`
is the O(N) encode by XORs and rolls. `ldpc_decode_layered` is the dense
layered tier: within a block-row the Z rows touch disjoint columns, so each
block-row is one conflict-free layer processed with immediate posterior
updates. The serving decoder is K15 (``kernels/ldpc_pallas.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.ldpc import LdpcCode, info_index, make_ldpc_code, minsum_c2v, syndrome_ok
from srcdsp_tpu_torch.types import F32


def make_qc_base(mb: int, nb: int, z: int, seed: int = 0) -> np.ndarray:
    """Deterministic girth-conditioned base matrix [mb, nb] of shifts, fully
    dense; every 2x2 submatrix satisfies the no-4-cycle condition. Raises if
    z is too small to satisfy it."""
    rng = np.random.default_rng(seed)
    base = np.zeros((mb, nb), np.int64)
    for j in range(nb):
        for i in range(mb):
            for _attempt in range(200):
                s = int(rng.integers(z))
                ok = True
                for i2 in range(i):
                    for j2 in range(j):
                        d = (base[i, j2] - base[i2, j2] + base[i2, j] - s) % z
                        if d == 0:
                            ok = False
                            break
                    if not ok:
                        break
                if ok:
                    base[i, j] = s
                    break
            else:
                raise ValueError(f"no 4-cycle-free shift found at ({i},{j}) "
                                 f"— increase z (got {z})")
    return base


def qc_expand(base: np.ndarray, z: int) -> np.ndarray:
    """Dense H [mb*z, nb*z] uint8 of a shift protograph; row r of a block
    has its 1 at column (r + s) mod z, -1 is the zero block."""
    base = np.asarray(base, np.int64)
    mb, nb = base.shape
    h = np.zeros((mb * z, nb * z), np.uint8)
    eye = np.eye(z, dtype=np.uint8)
    for i in range(mb):
        for j in range(nb):
            s = base[i, j]
            if s < 0:
                continue
            h[i * z:(i + 1) * z, j * z:(j + 1) * z] = np.roll(eye, int(s), axis=1)
    return h


def make_qc_ldpc(base: np.ndarray, z: int, device=None) -> LdpcCode:
    """The expanded QC code through `ldpc.make_ldpc_code`."""
    return make_ldpc_code(qc_expand(base, z), device=device)


def ldpc_decode_layered(code: LdpcCode, llr: torch.Tensor, z: int, iters: int = 12,
                        alpha: float = 0.8125):
    """Layered normalized min-sum. llr [..., N]; `z` is the circulant size
    (M % z == 0, one layer per block-row). Same return contract as
    `ldpc.ldpc_decode`: (bits, info, ok)."""
    h = code.h
    m, n = h.shape
    if m % z != 0:
        raise ValueError(f"M={m} not divisible by layer size z={z}")
    layers = m // z
    hl = h.reshape(layers, z, n)
    post = llr.to(F32)
    msg = [torch.zeros((*post.shape[:-1], z, n), dtype=F32, device=post.device)
           for _ in range(layers)]
    for _ in range(iters):
        for layer in range(layers):
            v2c = (post[..., None, :] - msg[layer]) * hl[layer]
            c2v = minsum_c2v(hl[layer], v2c, alpha)
            post = post + torch.sum(c2v - msg[layer], dim=-2)
            msg[layer] = c2v
    bits = (post < 0).to(torch.int32)
    return bits, bits[..., info_index(code)], syndrome_ok(bits, h)


# ---------------------------------------------------------------------------
# Standards-shaped construction + O(N) structured encoding
# ---------------------------------------------------------------------------

def load_qc_table(text: str) -> np.ndarray:
    """Parse a textual QC shift table: one base-matrix row per line, integers
    separated by whitespace or commas, `-1` or `-` for the zero block, `#`
    comments. Returns [mb, nb] int64."""
    rows = []
    for line in text.strip().splitlines():
        line = line.replace(",", " ").strip()
        if not line or line.startswith("#"):
            continue
        rows.append([-1 if tok == "-" else int(tok) for tok in line.split()])
    if not rows or any(len(r) != len(rows[0]) for r in rows):
        raise ValueError("ragged or empty shift table")
    return np.asarray(rows, np.int64)


def make_dual_diagonal_base(mb: int, nb: int, z: int, seed: int = 0,
                            p0_shift: int = 1) -> np.ndarray:
    """802.11n-shaped base matrix: a girth-conditioned systematic part and the
    dual-diagonal parity part (column kb carries p0_shift, 0 at the middle
    row, p0_shift; columns kb+1.. the zero-shift dual diagonal)."""
    if nb <= mb:
        raise ValueError(f"need nb > mb, got {nb} <= {mb}")
    if mb < 3:
        raise ValueError(f"dual-diagonal parity needs mb >= 3, got {mb}")
    rng = np.random.default_rng(seed)
    base = -np.ones((mb, nb), np.int64)
    kb = nb - mb
    mid = mb // 2
    base[0, kb] = p0_shift % z
    base[mid, kb] = 0
    base[mb - 1, kb] = p0_shift % z
    for j in range(mb - 1):
        base[j, kb + 1 + j] = 0
        base[j + 1, kb + 1 + j] = 0

    def makes_4cycle(i, j, s):
        for j2 in range(nb):
            if j2 == j or base[i, j2] < 0:
                continue
            for i2 in range(mb):
                if i2 == i or base[i2, j2] < 0 or base[i2, j] < 0:
                    continue
                if (s - base[i, j2] + base[i2, j2] - base[i2, j]) % z == 0:
                    return True
        return False

    for j in range(kb):
        for i in range(mb):
            for _attempt in range(400):
                s = int(rng.integers(z))
                if not makes_4cycle(i, j, s):
                    base[i, j] = s
                    break
            else:
                raise ValueError(f"no 4-cycle-free shift at ({i},{j}); "
                                 f"increase z (got {z})")
    return base


def qc_encode_dual_diagonal(base: np.ndarray, z: int, u) -> torch.Tensor:
    """O(N) encode for a dual-diagonal base: u [..., K] bits (K = (nb-mb)*z,
    a tensor or array) -> codewords [..., nb*z] int32 in H's column order,
    [info | p0 | q_0..q_{mb-2}], on u's device (the CPU for an array).

    Block-row i reads lambda_i = XOR_j roll(u_j, -s_ij); the block-rows sum
    to p0 = XOR_i lambda_i, then q_0 = lambda_0 ^ A_0 p0 and
    q_i = q_{i-1} ^ lambda_i ^ A_i p0.
    """
    base = np.asarray(base, np.int64)
    mb, nb = base.shape
    kb = nb - mb
    ui = torch.as_tensor(u).to(torch.int32)
    if ui.shape[-1] != kb * z:
        raise ValueError(f"u last dim {ui.shape[-1]} != K = {kb * z}")
    blocks = [ui[..., j * z:(j + 1) * z] for j in range(kb)]

    def shift(x, s):
        return torch.roll(x, -int(s), dims=-1)

    lam = []
    for i in range(mb):
        acc = torch.zeros_like(blocks[0])
        for j in range(kb):
            if base[i, j] >= 0:
                acc = acc ^ shift(blocks[j], base[i, j])
        lam.append(acc)
    p0 = lam[0]
    for i in range(1, mb):
        p0 = p0 ^ lam[i]
    qs = []
    prev = torch.zeros_like(p0)
    for i in range(mb - 1):
        t = prev ^ lam[i]
        if base[i, kb] >= 0:
            t = t ^ shift(p0, base[i, kb])
        qs.append(t)
        prev = t
    return torch.cat([ui, p0] + qs, dim=-1)
