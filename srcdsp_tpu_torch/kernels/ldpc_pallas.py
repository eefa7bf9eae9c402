"""LDPC min-sum decoder kernels K14 and K15 (counterpart of
``srcdsp_tpu/kernels/ldpc_pallas.py``).

- **K14, edge-form flooding** (`make_ldpc_kernel`, `make_ldpc_decoder`,
  `ldpc_decode_pallas`): for a generic H. Messages live per edge slot, in the
  plan's padded [dc, M_pad] row slots and [dv, N_pad] column slots, and move
  between the two through the plan's `row_src` / `col_src` index tables (the
  TPU kernel's 0/1 permutation matmul, as a gather). Every message is
  quantized to the bf16 grid (round to nearest even), so the decode is bit
  for bit the plain `ldpc_decode_edges_ref` on every device.
- **K15, quasi-cyclic layered** (`make_qc_kernel`, `make_qc_decoder`,
  `make_qc_decoder_t`, `qc_decode_layered_pallas`): check row r of a layer
  reads block-column j at row (r + s) mod z and its posterior delta goes back
  there; layers run serially with immediate posterior updates, all in
  float32 with no quantization. Kernel and plain `qc_decode_layered_ref` are
  bit for bit equal (every product and difference is rounded separately, as
  the eager reference does); against the jitted JAX kernel, whose compiler
  fuses ``alpha*es*em - old`` into one rounding, decisions are equal and
  posteriors about an ulp apart, the reference's own cross-backend contract.

Layouts are the JAX package's: the kernels take llr [N, B] column-major
(codewords along columns); the serving decoders take [B, N] (`make_*_decoder`)
or [N, B] (`make_qc_decoder_t`). The CUDA sources are ``csrc/ldpc.cu``. On a
CPU tensor the wrappers run the plain versions; on a CUDA tensor they launch
the kernel or raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.mixfir import check_f32_operand
from srcdsp_tpu_torch.ldpc import BIG as _BIG, LdpcCode, info_index, syndrome_ok
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import F32

BIG = float(_BIG)   # the finite mask magnitude, 1e30 rounded to float32
# shared memory a K15 block may take, so that two blocks share an SM
QC_SMEM_TARGET = 110 * 1024
SMEM_MAX = 227 * 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _q(x: torch.Tensor) -> torch.Tensor:
    """Quantize to the bf16 grid (round to nearest even), stay float32."""
    return x.to(torch.bfloat16).to(F32)


def _exclusive_min_sign(mag: torch.Tensor, sgn: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per slot d of the leading axis: the least magnitude and the product of
    the signs over the other slots (prefix/suffix selections: exact)."""
    big = torch.full_like(mag[:1], BIG)
    one = torch.ones_like(sgn[:1])
    pre = torch.cummin(mag, dim=0).values
    suf = torch.cummin(mag.flip(0), dim=0).values.flip(0)
    em = torch.minimum(torch.cat([big, pre[:-1]]), torch.cat([suf[1:], big]))
    ps = torch.cumprod(sgn, dim=0)
    ss = torch.cumprod(sgn.flip(0), dim=0).flip(0)
    es = torch.cat([one, ps[:-1]]) * torch.cat([ss[1:], one])
    return em, es


def _sign(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v < 0, -1.0, 1.0).to(F32)


# ---------------------------------------------------------------------------
# K14: generic-H edge plan and flooding decode
# ---------------------------------------------------------------------------

class EdgePlan(NamedTuple):
    """Static edge-form decode plan for a dense parity-check matrix (host
    numpy; the JAX plan's arrays bar its dense permutation matrix).

    Edge slots are padded to [dc, M_pad] / [dv, N_pad] grids (flattened into
    the leading axis; pads to 16). Messages move between row-major and
    column-major order by a gather through `row_src` / `col_src` (the TPU
    kernel multiplies by a 0/1 matrix with a one where col_src points).
    Invalid slots have no source (-1) and emit 0.
    """

    row_valid: np.ndarray  # [dc*M_pad, 1] f32 {0,1} real row-edge slots
    col_src: np.ndarray    # [dv*N_pad] int32 row slot feeding each column slot (-1 none)
    row_src: np.ndarray    # [dc*M_pad] int32 column slot feeding each row slot (-1 none)
    n: int
    m: int
    n_pad: int
    m_pad: int
    dv: int                # max column degree
    dc: int                # max row degree


def plan_edges(h: np.ndarray) -> EdgePlan:
    """The static edge plan of H [M, N] of {0,1}."""
    h = np.asarray(h) != 0
    m, n = h.shape
    dc = int(h.sum(axis=1).max())
    dv = int(h.sum(axis=0).max())
    if dc < 2:
        raise ValueError("need row degree >= 2 for a check update")
    m_pad = _round_up(m, 16)
    n_pad = _round_up(n, 16)
    e_row = dc * m_pad
    e_col = dv * n_pad
    row_valid = np.zeros((e_row, 1), np.float32)
    col_src = np.full(e_col, -1, np.int32)
    row_src = np.full(e_row, -1, np.int32)
    col_fill = np.zeros(n, np.int64)
    for r in range(m):
        for d, c in enumerate(np.flatnonzero(h[r])):
            q_slot = d * m_pad + r
            p_slot = int(col_fill[c]) * n_pad + int(c)
            col_fill[c] += 1
            row_valid[q_slot, 0] = 1.0
            col_src[p_slot] = q_slot
            row_src[q_slot] = p_slot
    return EdgePlan(row_valid=row_valid, col_src=col_src, row_src=row_src, n=n, m=m,
                    n_pad=n_pad, m_pad=m_pad, dv=dv, dc=dc)


def _minsum_edges(v: torch.Tensor, valid: torch.Tensor, alpha: float) -> torch.Tensor:
    """Normalized min-sum over the dc row slots v [dc, M_pad, B] (quantized
    v2c): c = q((alpha*es)*em), 0 where every other slot is empty (em >= BIG,
    degree-1 rows) and 0 in invalid slots."""
    mag = torch.where(valid, torch.abs(v), BIG)
    sgn = torch.where(valid, _sign(v), 1.0)
    em, es = _exclusive_min_sign(mag, sgn)
    c = _q((np.float32(alpha) * es) * em)
    c = torch.where(em >= BIG, 0.0, c)
    return torch.where(valid, c, 0.0)


def ldpc_decode_edges_ref(plan: EdgePlan, llr: torch.Tensor, iters: int = 10,
                          alpha: float = 0.8125) -> torch.Tensor:
    """Plain K14: quantized edge-form flooding min-sum.

    llr [N, B] (codewords along columns) -> posterior [N, B] float32. The
    posterior sums lf + c_0 + ... + c_{dv-1} in that order, as the kernel does.
    """
    p = plan
    dev = llr.device
    b = llr.shape[-1]
    lf = torch.zeros((p.n_pad, b), dtype=F32, device=dev)
    lf[:p.n] = _q(llr.to(F32))
    rs = torch.as_tensor(np.maximum(p.row_src, 0), dtype=torch.int64, device=dev)
    cs = torch.as_tensor(np.maximum(p.col_src, 0), dtype=torch.int64, device=dev)
    rvalid = torch.as_tensor(p.row_src >= 0, device=dev).reshape(p.dc, p.m_pad, 1)
    cvalid = torch.as_tensor(p.col_src >= 0, device=dev).reshape(p.dv, p.n_pad, 1)

    def posterior(c):
        post = lf
        for j in range(p.dv):
            post = post + c[j]
        return post

    c = torch.zeros((p.dv, p.n_pad, b), dtype=F32, device=dev)
    for _ in range(iters):
        v = _q(posterior(c) - c)                                   # column slots
        r = torch.where(rvalid, v.reshape(-1, b)[rs].reshape(p.dc, p.m_pad, b), 0.0)
        new_r = _minsum_edges(r, rvalid, alpha)                    # row slots
        c = torch.where(cvalid, new_r.reshape(-1, b)[cs].reshape(p.dv, p.n_pad, b), 0.0)
    return posterior(c)[:p.n]


def _edges_fn(plan: EdgePlan, iters: int, alpha: float, device: torch.device):
    """(llr [N, B] float32 contiguous on `device`) -> posterior [N, B]: K14 on
    a CUDA tensor, the plain version on a CPU tensor."""
    p = plan
    rs = torch.as_tensor(p.row_src, device=device)
    cs = torch.as_tensor(p.col_src, device=device)

    def fn(llr: torch.Tensor) -> torch.Tensor:
        if not check_f32_operand(llr, device, "llr"):
            return ldpc_decode_edges_ref(p, llr, iters, alpha)
        llr = llr.contiguous()
        b = llr.shape[1]
        post = torch.empty((p.n, b), dtype=F32, device=device)
        rc = _build.load().srcdsp_ldpc_edges(
            llr.data_ptr(), rs.data_ptr(), cs.data_ptr(), post.data_ptr(), p.n, p.n_pad,
            p.m_pad, p.dv, p.dc, b, iters, alpha, _build.stream_handle(llr))
        _build.check(rc, "ldpc_edges")
        _build.LAUNCHES["ldpc_edges"] += 1
        return post

    return fn


def make_ldpc_kernel(plan: EdgePlan, iters: int = 10, alpha: float = 0.8125,
                     b_tile: int = 128, device=None):
    """K14: run(llr [N, B] float32) -> posterior [N, B] float32, B a
    multiple of b_tile (the TPU kernel's batch tile, kept as the contract)."""
    fn = _edges_fn(plan, iters, alpha, resolve(device))

    def run(llr: torch.Tensor) -> torch.Tensor:
        n, b = llr.shape
        if n != plan.n or b % b_tile:
            raise ValueError(f"llr [{n},{b}] vs plan n={plan.n}, tile {b_tile}")
        return fn(llr)

    return run


def make_ldpc_decoder(code: LdpcCode, plan: EdgePlan, iters: int = 10,
                      alpha: float = 0.8125, device=None):
    """Serving K14 decode: dec(llr [B, N]) -> (bits [B, N] int32, info
    [B, K] int32, ok [B] bool), the contract of `ldpc.ldpc_decode`. Any B:
    the TPU version pads B to its batch tile, the CUDA kernel needs no
    padding, so there is no b_tile."""
    device = resolve(device)
    fn = _edges_fn(plan, iters, alpha, device)
    h = code.h.to(device)
    info_idx = info_index(code).to(device)

    def dec(llr: torch.Tensor):
        post = fn(llr.to(F32).T.contiguous())
        bits = (post.T < 0).to(torch.int32)
        return bits, bits[:, info_idx], syndrome_ok(bits, h)

    return dec


def ldpc_decode_pallas(code: LdpcCode, plan: EdgePlan, llr: torch.Tensor, iters: int = 10,
                       alpha: float = 0.8125):
    """One-shot `make_ldpc_decoder` on llr's device (serving code builds the
    decoder once)."""
    return make_ldpc_decoder(code, plan, iters=iters, alpha=alpha, device=llr.device)(llr)


# ---------------------------------------------------------------------------
# K15: quasi-cyclic layered decode
# ---------------------------------------------------------------------------

class QcPlan(NamedTuple):
    """Static plan of a QC base matrix: per layer, the participating
    block-columns and their circulant shifts (host tuples)."""

    layers: tuple          # (cols tuple, shifts tuple) per layer
    z: int
    nb: int
    n_blocks: int          # non-zero circulants (message slabs)


def plan_qc(base: np.ndarray, z: int) -> QcPlan:
    """The layer plan of a shift protograph. z must be a multiple of 8 and
    every layer must have degree >= 2 (the reference's checks)."""
    if z % 8:
        raise ValueError(f"z={z} must be a multiple of 8 (sublane tile)")
    base = np.asarray(base, np.int64)
    layers = []
    for i in range(base.shape[0]):
        cols = tuple(int(j) for j in np.flatnonzero(base[i] >= 0))
        if len(cols) < 2:
            raise ValueError(f"layer {i} has degree < 2")
        shifts = tuple(int(base[i, j]) % z for j in cols)
        layers.append((cols, shifts))
    return QcPlan(layers=tuple(layers), z=z, nb=base.shape[1],
                  n_blocks=sum(len(c) for c, _ in layers))


def qc_decode_layered_ref(plan: QcPlan, llr: torch.Tensor, iters: int = 6,
                          alpha: float = 0.8125) -> torch.Tensor:
    """Plain K15: llr [nb*z, B] -> posterior [nb*z, B] float32.

    Per layer: v = roll(post_j, -s) - old, new = (alpha*es)*em,
    post_j = post_j + roll(new - old, s), each operation rounded on its own.
    """
    z = plan.z
    post = llr.to(F32).clone()
    msgs = [torch.zeros((z, llr.shape[-1]), dtype=F32, device=llr.device)
            for _ in range(plan.n_blocks)]
    for _ in range(iters):
        slab = 0
        for cols, shifts in plan.layers:
            old = msgs[slab:slab + len(cols)]
            v = torch.stack([torch.roll(post[c * z:(c + 1) * z], -s, 0) - o
                             for c, s, o in zip(cols, shifts, old)])
            em, es = _exclusive_min_sign(torch.abs(v), _sign(v))
            new = (np.float32(alpha) * es) * em
            for d, (c, s) in enumerate(zip(cols, shifts)):
                post[c * z:(c + 1) * z] = post[c * z:(c + 1) * z] + torch.roll(new[d] - old[d], s,
                                                                               0)
                msgs[slab + d] = new[d]
            slab += len(cols)
    return post


def qc_codewords_per_block(plan: QcPlan) -> int:
    """Codewords one K15 block decodes: the most of 8, 4, 2, 1 whose
    posteriors and messages fit QC_SMEM_TARGET bytes of shared memory."""
    per_cw = (plan.nb + plan.n_blocks) * plan.z * 4
    if per_cw > SMEM_MAX:
        raise ValueError(f"one codeword needs {per_cw} B of shared memory (> {SMEM_MAX})")
    for cw in (8, 4, 2):
        if cw * per_cw <= QC_SMEM_TARGET and cw * plan.z <= 1024:
            return cw
    return 1


def _qc_fn(plan: QcPlan, iters: int, alpha: float, device: torch.device):
    """(llr [nb*z, B] float32 on `device`) -> posterior: K15 on a CUDA
    tensor, the plain version on a CPU tensor."""
    n = plan.nb * plan.z
    starts = np.cumsum([0] + [len(c) for c, _ in plan.layers]).astype(np.int32)
    cols = np.asarray([j for c, _ in plan.layers for j in c], np.int32)
    shifts = np.asarray([s for _, sh in plan.layers for s in sh], np.int32)
    tables = [torch.as_tensor(a, device=device) for a in (starts, cols, shifts)]
    cw = qc_codewords_per_block(plan)

    def fn(llr: torch.Tensor) -> torch.Tensor:
        if not check_f32_operand(llr, device, "llr"):
            return qc_decode_layered_ref(plan, llr, iters, alpha)
        llr = llr.contiguous()
        b = llr.shape[1]
        post = torch.empty((n, b), dtype=F32, device=device)
        rc = _build.load().srcdsp_ldpc_qc(
            llr.data_ptr(), *(t.data_ptr() for t in tables), post.data_ptr(),
            len(plan.layers), plan.z, plan.nb, plan.n_blocks, b, iters, cw, alpha,
            _build.stream_handle(llr))
        _build.check(rc, "ldpc_qc")
        _build.LAUNCHES["ldpc_qc"] += 1
        return post

    return fn


def make_qc_kernel(plan: QcPlan, iters: int = 6, alpha: float = 0.8125, b_tile: int = 128,
                   device=None):
    """K15: run(llr [nb*z, B] float32) -> posterior [nb*z, B], B a multiple
    of b_tile."""
    n = plan.nb * plan.z
    fn = _qc_fn(plan, iters, alpha, resolve(device))

    def run(llr: torch.Tensor) -> torch.Tensor:
        nn, b = llr.shape
        if nn != n or b % b_tile:
            raise ValueError(f"llr [{nn},{b}] vs plan n={n}, tile {b_tile}")
        return fn(llr)

    return run


def make_qc_decoder(code: LdpcCode, plan: QcPlan, iters: int = 6, alpha: float = 0.8125,
                    device=None):
    """Serving K15 decode: dec(llr [B, N]) -> (bits, info, ok), the contract
    of `qcldpc.ldpc_decode_layered`. Any B (no b_tile, as for
    `make_ldpc_decoder`)."""
    device = resolve(device)
    fn = _qc_fn(plan, iters, alpha, device)
    h = code.h.to(device)
    info_idx = info_index(code).to(device)

    def dec(llr: torch.Tensor):
        post = fn(llr.to(F32).T.contiguous())
        bits = (post.T < 0).to(torch.int32)
        return bits, bits[:, info_idx], syndrome_ok(bits, h)

    return dec


def make_qc_decoder_t(code: LdpcCode, plan: QcPlan, iters: int = 6, alpha: float = 0.8125,
                      b_tile: int = 128, device=None):
    """Column-major serving K15 decode: run(llr_t [N, B]) -> (bits_t [N, B]
    int32, ok [B] bool), B a multiple of b_tile: no transpose anywhere, the
    syndrome one [M, N] x [N, B] product (float32, TF32 off)."""
    device = resolve(device)
    n = plan.nb * plan.z
    fn = _qc_fn(plan, iters, alpha, device)
    h = code.h.to(device)

    def run(llr_t: torch.Tensor):
        nn, b = llr_t.shape
        if nn != n or b % b_tile:
            raise ValueError(f"llr_t [{nn},{b}] vs n={n}, tile {b_tile}")
        bits_t = (fn(llr_t.to(F32)) < 0).to(torch.int32)
        pin_f32(bits_t)
        syn = torch.remainder(h @ bits_t.to(F32), 2.0)
        return bits_t, torch.all(syn == 0, dim=0)

    return run


def qc_decode_layered_pallas(code: LdpcCode, plan: QcPlan, llr: torch.Tensor, iters: int = 6,
                             alpha: float = 0.8125):
    """One-shot `make_qc_decoder` on llr's device."""
    return make_qc_decoder(code, plan, iters=iters, alpha=alpha, device=llr.device)(llr)
