"""LDPC min-sum decoder kernels K14 and K15 (counterpart of
``srcdsp_tpu/kernels/ldpc_pallas.py``).

- **K14, edge-form flooding** (`make_ldpc_kernel`, `make_ldpc_decoder`,
  `ldpc_decode_pallas`): for a generic H. The plain version keeps messages
  per edge slot, in the plan's padded [dc, M_pad] row slots and [dv, N_pad]
  column slots, and moves them between the two through the plan's `row_src` /
  `col_src` index tables (the TPU kernel's 0/1 permutation matmul, as a
  gather). The CUDA kernel keeps only the column slots: a check row reads its
  columns' posteriors and its own old messages there (`edges_decode_colslot`
  mirrors that schedule). Every message is quantized to the bf16 grid (round
  to nearest even), so the decode is bit for bit the plain
  `ldpc_decode_edges_ref` on every device.
- **K15, quasi-cyclic layered** (`make_qc_kernel`, `make_qc_decoder`,
  `make_qc_decoder_t`, `qc_decode_layered_pallas`): check row r of a layer
  reads block-column j at row (r + s) mod z and its posterior delta goes back
  there; layers run serially with immediate posterior updates, all in
  float32 with no quantization. The CUDA kernel stores no message: it
  rebuilds a row's old messages from a compressed check state
  (`qc_decode_compressed` mirrors that schedule). Kernel and plain
  `qc_decode_layered_ref` are bit for bit equal (every product and
  difference is rounded separately, as the eager reference does); against
  the jitted JAX kernel, whose compiler fuses ``alpha*es*em - old`` into one
  rounding, decisions are equal and posteriors about an ulp apart, the
  reference's own cross-backend contract.

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
SMEM_MAX = 227 * 1024       # shared memory a block may take
MAX_THREADS = 1024
SMS = 132                   # an H100's SMs, where no card is asked
# K14: codewords a block (at most) and a thread
EDGES_CW, EDGES_CPT = 8, 4
# K15: (codewords a block, a thread) in order of preference (bench_torch/
# ab_ldpc.py), and the shared memory a block may take so that two blocks
# share an SM
QC_GEOMETRIES = ((8, 4), (4, 2), (2, 2))
QC_SMEM_TARGET = 110 * 1024
QC_CHUNK = 16               # edges of a row whose sign bits share a K15 state word


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


def _row_edges(plan: EdgePlan) -> np.ndarray:
    """[dc, M_pad, 2] int32: slot d of check row r as (column, column slot
    j*N_pad + column), (-1, -1) where the row has no d-th edge."""
    p = plan
    slot = p.row_src.reshape(p.dc, p.m_pad)
    return np.stack([np.where(slot >= 0, slot % p.n_pad, -1), slot], -1).astype(np.int32)


def edges_decode_colslot(plan: EdgePlan, llr: torch.Tensor, iters: int = 10,
                         alpha: float = 0.8125) -> torch.Tensor:
    """K14's schedule in torch (``csrc/ldpc.cu:184-287`` ldpc_edges_kernel:
    the variable phase at :202, the check phase at :217): only the
    column-slot messages Rc [dv, N_pad, B] exist. A check row forms v_d =
    q(post[col_d] - Rc[slot_d]) (its own old message in that slot: the
    reference's v2c there), takes the strict-< min1/min2/arg and parity over
    its dc slots in order (an empty slot magnitude BIG), and writes c =
    em >= BIG ? 0 : +-q(alpha*em) back to its slots (the reference's
    q((alpha*es)*em): alpha*es is exact and both roundings are symmetric);
    the variable phase sums lf + Rc[0] + ... + Rc[dv-1]. Bit for bit
    `ldpc_decode_edges_ref`."""
    p = plan
    dev = llr.device
    b = llr.shape[-1]
    lf = torch.zeros((p.n_pad, b), dtype=F32, device=dev)
    lf[:p.n] = _q(llr.to(F32))
    re = torch.as_tensor(_row_edges(p), dtype=torch.int64, device=dev)
    valid = (re[..., 0] >= 0)[..., None]                           # [dc, M_pad, 1]
    col, slot = re[..., 0].clamp(min=0), re[..., 1].clamp(min=0)
    rc = torch.zeros((p.dv * p.n_pad, b), dtype=F32, device=dev)

    def posterior():
        post = lf
        for j in range(p.dv):
            post = post + rc[j * p.n_pad:(j + 1) * p.n_pad]
        return post

    for _ in range(iters):
        post = posterior()
        v = [_q(post[col[d]] - rc[slot[d]]) for d in range(p.dc)]
        min1 = torch.full((p.m_pad, b), float("inf"), dtype=F32, device=dev)
        min2 = min1.clone()
        arg = torch.full((p.m_pad, b), -1, dtype=torch.int64, device=dev)
        par = torch.zeros((p.m_pad, b), dtype=torch.bool, device=dev)
        for d in range(p.dc):
            mag = torch.where(valid[d], torch.abs(v[d]), BIG)
            lt1, lt2 = mag < min1, mag < min2
            min2 = torch.where(lt1, min1, torch.where(lt2, mag, min2))
            min1 = torch.where(lt1, mag, min1)
            arg = torch.where(lt1, d, arg)
            par = par ^ (valid[d] & (v[d] < 0))
        for d in range(p.dc):
            em = torch.where(arg == d, min2, min1)
            mag = _q(np.float32(alpha) * em)                       # +-q(alpha*em)
            c = torch.where(em >= BIG, 0.0, torch.where(par != (v[d] < 0), -mag, mag))
            rows = valid[d, :, 0]
            rc[slot[d][rows]] = c[rows]
    return posterior()[:p.n]


class EdgesGeometry(NamedTuple):
    """A K14 launch: codewords a block (cw) and a thread (cpt), threads a
    block, shared bytes a block (lf, posteriors and Rc, [*][cw] each)."""

    cw: int
    cpt: int
    threads: int
    smem: int


def edges_geometry(plan: EdgePlan) -> EdgesGeometry:
    """The most codewords a block, up to EDGES_CW, whose shared memory fits."""
    per_cw = (2 + plan.dv) * plan.n_pad * 4
    cw = EDGES_CW
    while cw > 1 and cw * per_cw > SMEM_MAX:
        cw //= 2
    if cw * per_cw > SMEM_MAX:
        raise ValueError(f"one codeword needs {per_cw} B of shared memory (> {SMEM_MAX})")
    cpt = min(EDGES_CPT, cw)
    threads = min(MAX_THREADS, _round_up(max(plan.m, 1) * (cw // cpt), 32))
    return EdgesGeometry(cw=cw, cpt=cpt, threads=threads, smem=cw * per_cw)


def _edges_fn(plan: EdgePlan, iters: int, alpha: float, device: torch.device):
    """(llr [N, B] float32 contiguous on `device`) -> posterior [N, B]: K14 on
    a CUDA tensor, the plain version on a CPU tensor."""
    p = plan
    geo = edges_geometry(p)
    row_edges = torch.as_tensor(_row_edges(p), device=device)

    def fn(llr: torch.Tensor) -> torch.Tensor:
        if not check_f32_operand(llr, device, "llr"):
            return ldpc_decode_edges_ref(p, llr, iters, alpha)
        llr = llr.contiguous()
        b = llr.shape[1]
        post = torch.empty((p.n, b), dtype=F32, device=device)
        rc = _build.load().srcdsp_ldpc_edges(
            llr.data_ptr(), row_edges.data_ptr(), post.data_ptr(), p.n, p.n_pad, p.m, p.m_pad,
            p.dv, p.dc, b, iters, alpha, geo.cw, geo.cpt, geo.threads, _build.stream_handle(llr))
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


def _rebuild(word: torch.Tensor, dd: int, is_arg: torch.Tensor, a1: torch.Tensor,
             a2: torch.Tensor) -> torch.Tensor:
    """An old K15 message from the check state: +-(is_arg ? a2 : a1), the
    sign bit dd of the chunk's state word."""
    mag = torch.where(is_arg, a2, a1)
    return torch.where((word >> dd) & 1 == 1, -mag, mag)


def qc_decode_compressed(plan: QcPlan, llr: torch.Tensor, iters: int = 6,
                         alpha: float = 0.8125) -> torch.Tensor:
    """K15's schedule in torch (``csrc/ldpc.cu:320-445`` ldpc_qc_kernel:
    pass 1 at :369, pass 2 at :407, the old messages rebuilt as at :291): no
    message is stored. Per (layer, row, codeword) the check state is a1 = alpha*min1,
    a2 = alpha*min2 and words of 16 edges' sign bits (word 0 also holds the
    first minimum's index in its high half); old_d = +-(d == arg ? a2 : a1).
    Pass 1 takes v = p - old, the strict-< min1/min2/arg in slab order and the
    parity; pass 2 writes p + (new - old) with new = +-(d == arg ? a2' : a1').
    Bit for bit `qc_decode_layered_ref`."""
    z = plan.z
    b = llr.shape[-1]
    dev = llr.device
    post = llr.to(F32).clone()
    n_layers = len(plan.layers)
    words = -(-max(len(c) for c, _ in plan.layers) // QC_CHUNK)
    a1 = torch.zeros((n_layers, z, b), dtype=F32, device=dev)
    a2 = torch.zeros_like(a1)
    w = torch.zeros((n_layers, words, z, b), dtype=torch.int64, device=dev)
    rows = torch.arange(z, device=dev)
    for _ in range(iters):
        for l, (cols, shifts) in enumerate(plan.layers):
            idx = [c * z + (rows + s) % z for c, s in zip(cols, shifts)]
            oarg = (w[l, 0] >> 16) & 0xFFFF
            olds = [_rebuild(w[l, d // QC_CHUNK], d % QC_CHUNK, oarg == d, a1[l], a2[l])
                    for d in range(len(cols))]
            min1 = torch.full((z, b), float("inf"), dtype=F32, device=dev)
            min2 = min1.clone()
            arg = torch.full((z, b), -1, dtype=torch.int64, device=dev)
            par = torch.zeros((z, b), dtype=torch.bool, device=dev)
            for d, old in enumerate(olds):
                v = post[idx[d]] - old
                mag = torch.abs(v)
                lt1, lt2 = mag < min1, mag < min2
                min2 = torch.where(lt1, min1, torch.where(lt2, mag, min2))
                min1 = torch.where(lt1, mag, min1)
                arg = torch.where(lt1, d, arg)
                par = par ^ (v < 0)
            na1, na2 = np.float32(alpha) * min1, np.float32(alpha) * min2
            nw = torch.zeros((words, z, b), dtype=torch.int64, device=dev)
            nw[0] = (arg & 0xFFFF) << 16
            for d, old in enumerate(olds):
                p = post[idx[d]]
                sgn = (p - old < 0) != par
                a = torch.where(arg == d, na2, na1)
                post[idx[d]] = p + (torch.where(sgn, -a, a) - old)
                nw[d // QC_CHUNK] |= sgn.to(torch.int64) << (d % QC_CHUNK)
            a1[l], a2[l], w[l] = na1, na2, nw
    return post


# where K15 keeps its check state (csrc/ldpc.cu State)
QC_STATES = ("shared", "device")


class QcGeometry(NamedTuple):
    """A K15 launch: codewords a block (cw, a power of 2) and a thread
    (cpt), threads a block, shared bytes a block, state words a (layer, row,
    codeword) beside a1 and a2, and where the check state lives: in shared
    memory, or in device memory (a region a block) where it fits no shared
    memory."""

    cw: int
    cpt: int
    threads: int
    smem: int
    words: int
    state: str


def qc_geometry(plan: QcPlan, b: int | None = None, sms: int = SMS) -> QcGeometry:
    """The first of QC_GEOMETRIES (codewords a block, a thread) whose shared
    memory fits QC_SMEM_TARGET bytes and, for a batch of `b`, still gives
    every one of `sms` SMs a block (else the last that fits); past the
    target 2 and 2, then 1 and 1, within the card's limit; else 1 and 1 with
    the state in device memory. A plan whose posteriors alone exceed the
    limit raises."""
    z, n_layers = plan.z, len(plan.layers)
    words = -(-max(len(c) for c, _ in plan.layers) // QC_CHUNK)
    ps = plan.nb * z * 4
    state = n_layers * z * (2 + words) * 4
    tables = plan.n_blocks * 8 + (n_layers + 1) * 4

    def geo(cw, cpt, where="shared"):
        return QcGeometry(cw=cw, cpt=cpt,
                          threads=min(MAX_THREADS, _round_up(z * (cw // cpt), 32)),
                          smem=cw * (ps + (state if where == "shared" else 0)) + tables,
                          words=words, state=where)

    fit = [geo(cw, cpt) for cw, cpt in QC_GEOMETRIES]
    fit = [g for g in fit if g.smem <= QC_SMEM_TARGET]
    if fit:
        full = [g for g in fit if b is None or -(-b // g.cw) >= sms]
        return full[0] if full else fit[-1]
    for g in (geo(2, 2), geo(1, 1), geo(1, 1, "device")):
        if g.smem <= SMEM_MAX:
            return g
    raise ValueError(f"one codeword needs {ps + tables} B of shared memory (> {SMEM_MAX})")


def _qc_fn(plan: QcPlan, iters: int, alpha: float, device: torch.device):
    """(llr [nb*z, B] float32 on `device`) -> posterior: K15 on a CUDA
    tensor, the plain version on a CPU tensor."""
    n = plan.nb * plan.z
    starts = np.cumsum([0] + [len(c) for c, _ in plan.layers]).astype(np.int32)
    cols = np.asarray([j for c, _ in plan.layers for j in c], np.int32)
    shifts = np.asarray([s for _, sh in plan.layers for s in sh], np.int32)
    tables = [torch.as_tensor(a, device=device) for a in (starts, cols, shifts)]
    qc_geometry(plan)  # raises here for a plan no geometry holds
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else SMS)
    geos: dict[int, QcGeometry] = {}

    def fn(llr: torch.Tensor) -> torch.Tensor:
        if not check_f32_operand(llr, device, "llr"):
            return qc_decode_layered_ref(plan, llr, iters, alpha)
        llr = llr.contiguous()
        b = llr.shape[1]
        geo = geos.get(b)
        if geo is None:
            geo = geos[b] = qc_geometry(plan, b, sms)
        post = torch.empty((n, b), dtype=F32, device=device)
        gstate = (torch.empty((-(-b // geo.cw) * len(plan.layers) * plan.z * geo.cw
                               * (2 + geo.words),), dtype=F32, device=device)
                  if geo.state == "device" else None)
        rc = _build.load().srcdsp_ldpc_qc(
            llr.data_ptr(), *(t.data_ptr() for t in tables), post.data_ptr(),
            gstate.data_ptr() if gstate is not None else None, len(plan.layers), plan.z,
            plan.nb, plan.n_blocks, geo.words, b, iters, geo.cw.bit_length() - 1, geo.cpt,
            QC_STATES.index(geo.state), alpha, geo.threads, geo.smem, _build.stream_handle(llr))
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
