"""Max-log BCJR kernel K16 and the turbo decoder over it (counterpart of
``srcdsp_tpu/kernels/bcjr_pallas.py``).

`make_bcjr_kernel` builds fn(ls_tot [t_len, B], lp [t_len, B]) -> post
[t_len, B] for the 8-state RSC code: ls_tot is the systematic LLR plus the
a-priori (`turbo.bcjr_decode_batch`'s ``ls``), the extrinsic post - ls_tot is
the caller's. Bit for bit `bcjr_decode_batch`: the same association per
element, the recurrences carrying the normalized metric and the posterior
reading the un-normalized step outputs. For codes whose forward polynomial
taps the current bit, par[s, 1] == 1 - par[s, 0], so gamma[s, 1] =
-gamma[s, 0] and one value per state holds every branch metric (the builder
checks this and the 8 states).

The CUDA kernel is ``csrc/bcjr.cu``: one codeword a thread, its trellis
static but for two masks (`trellis_masks`), a forward and a backward warp
running the two recursions at once, then every warp of the block writing
posteriors from the stored histories. `bcjr_schedule` runs that schedule in
torch. On a CPU tensor the wrapper runs the plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.mixfir import check_f32_operand
from srcdsp_tpu_torch.turbo import (NEG, RscCode, TurboCode, bcjr_decode_batch,
                                    turbo_iterations)
from srcdsp_tpu_torch.types import F32


def masks_trellis(c_mask: int, par_mask: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The tables that bcjr.cu:13-20 assumes, from its two masks: (next_state,
    prev_state, parity) [8, 2] int32. next[s, u] = ((u ^ f(s)) << 2) | (s >>
    1) with f(2j) = bit j of c_mask and f(2j + 1) = 1 - f(2j); par[s, 0] = bit
    s of par_mask and par[s, 1] = 1 - par[s, 0]."""
    s = np.arange(8)
    f = ((c_mask >> (s >> 1)) & 1) ^ (s & 1)
    u = np.arange(2)
    nxt = ((u[None, :] ^ f[:, None]) << 2) | (s[:, None] >> 1)
    prev = np.zeros((8, 2), np.int64)
    prev[nxt, u[None, :]] = s[:, None]
    p0 = (par_mask >> s) & 1
    return (nxt.astype(np.int32), prev.astype(np.int32),
            np.stack([p0, 1 - p0], 1).astype(np.int32))


def trellis_masks(code: RscCode) -> tuple[int, int]:
    """(c_mask, par_mask) of an 8-state code (bcjr.cu:66-72): bit j of c_mask
    is f(2j) = next_state[2j, 0] >> 2, bit s of par_mask is par[s, 0]. Raises
    unless `masks_trellis` rebuilds the code's next_state, prev_state and
    parity from them."""
    nxt, par = np.asarray(code.next_state), np.asarray(code.parity)
    c_mask = sum(int(nxt[2 * j, 0] >> 2) << j for j in range(4))
    par_mask = sum(int(par[s, 0]) << s for s in range(8))
    rebuilt = masks_trellis(c_mask, par_mask)
    if not all(np.array_equal(a, np.asarray(b)) for a, b in
               zip(rebuilt, (code.next_state, code.prev_state, code.parity))):
        raise ValueError("kernel needs the trellis next[s, u] = ((u ^ f(s)) << 2) | (s >> 1) "
                         "with f(2j+1) = 1 - f(2j) (feedback polynomial must tap the last "
                         "register)")
    return c_mask, par_mask


def bcjr_schedule(c_mask: int, par_mask: int, ls_tot: torch.Tensor, lp: torch.Tensor,
                  terminated: bool) -> torch.Tensor:
    """K16's schedule (bcjr.cu:219-290) in torch over [t, B]: the state
    metrics as [8, B], the gathers as the kernel's static pair selects; the
    forward recursion over steps 0 .. t-1 storing each step's un-normalized
    alpha and the backward one over t-1 .. 0 storing each step's
    un-normalized beta (the kernel's tiles [t, G, 8, 32] hold the same
    values), then every step's posterior from the two histories. Returns
    post [t, B]; equal to `bcjr_decode_batch`'s bit for bit."""
    t, b = ls_tot.shape
    dev = ls_tot.device
    c = [bool((c_mask >> j) & 1) for j in range(4)]
    p = torch.tensor([bool((par_mask >> s) & 1) for s in range(8)], device=dev)[:, None]
    ev, od = slice(0, 8, 2), slice(1, 8, 2)

    def sel(m, x, y):  # bcjr.cu:73-77, a static select: m ? x : y per pair j
        return torch.stack([x[j] if m[j] else y[j] for j in range(4)])

    def gammas(u):  # bcjr.cu:84-91
        hs, hp = 0.5 * ls_tot[u], 0.5 * lp[u]
        return torch.where(p, (hs + -hp)[None], (hs + hp)[None])

    def alpha_step(gr, an):  # bcjr.cu:92-113
        av, bv = an + gr, an + -gr
        x = torch.maximum(av[ev], bv[od])
        y = torch.maximum(av[od], bv[ev])
        au = torch.cat([sel(c, y, x), sel(c, x, y)])
        return au, au - au.amax(0)

    def pairs(bt):  # bcjr.cu:115-116, 121-122: next0(2j) = next1(2j + 1) = c_j ? 4|j : j
        return sel(c, bt[4:], bt[:4]), sel(c, bt[:4], bt[4:])

    def beta_step(gr, bn):  # bcjr.cu:115-129
        pp, qq = pairs(bn)
        bu = torch.empty_like(bn)
        bu[ev] = torch.maximum(gr[ev] + pp, -gr[ev] + qq)
        bu[od] = torch.maximum(gr[od] + qq, -gr[od] + pp)
        return bu, bu - bu.amax(0)

    def posterior(au, gr, bt):  # bcjr.cu:131-145
        pp, qq = pairs(bt)
        v0, v1 = torch.empty_like(au), torch.empty_like(au)
        v0[ev], v1[ev] = (au[ev] + gr[ev]) + pp, (au[ev] + -gr[ev]) + qq
        v0[od], v1[od] = (au[od] + gr[od]) + qq, (au[od] + -gr[od]) + pp
        return v0.amax(0) - v1.amax(0)

    start = torch.full((8, b), NEG, dtype=F32, device=dev)
    start[0] = 0.0
    alphas = torch.empty((t, 8, b), dtype=F32, device=dev)
    betas = torch.empty((t, 8, b), dtype=F32, device=dev)
    fa = (start, start)                                    # warp 0: (au, an)
    bw = (start, start) if terminated else (torch.zeros_like(start),) * 2
    for u in range(t):                                     # warp 0, forward
        alphas[u] = fa[0]
        fa = alpha_step(gammas(u), fa[1])
    for u in range(t - 1, -1, -1):                         # warp 1, backward
        betas[u] = bw[0]
        bw = beta_step(gammas(u), bw[1])
    return torch.stack([posterior(alphas[u], gammas(u), betas[u])  # every warp
                        for u in range(t)])


def make_bcjr_kernel(code: RscCode, t_len: int, terminated: bool, b_tile: int = 128,
                     device=None):
    """K16 for a fixed block length: fn(ls_tot, lp) [t_len, B] float32 ->
    post [t_len, B], B a multiple of b_tile (the TPU kernel's lane tile,
    kept as the contract)."""
    if 1 << (code.k - 1) != 8:
        raise ValueError("kernel is specialized to 8-state codes")
    par = np.asarray(code.parity)
    if not np.all(par[:, 1] == 1 - par[:, 0]):
        raise ValueError("kernel needs par[s,1] == 1 - par[s,0] "
                         "(forward polynomial must tap the current bit)")
    c_mask, par_mask = trellis_masks(code)
    device = resolve(device)

    def fn(ls_tot: torch.Tensor, lp: torch.Tensor) -> torch.Tensor:
        t, bsz = ls_tot.shape
        if t != t_len or bsz % b_tile:
            raise ValueError(f"[{t},{bsz}] vs t_len={t_len}, b_tile={b_tile}")
        if lp.shape != ls_tot.shape:
            raise ValueError(f"lp {tuple(lp.shape)} != ls_tot {tuple(ls_tot.shape)}")
        on_card = check_f32_operand(ls_tot, device, "ls_tot")
        check_f32_operand(lp, device, "lp")
        if not on_card:
            return bcjr_decode_batch(code, ls_tot, lp, terminated=terminated)[0]
        ls_c, lp_c = ls_tot.contiguous(), lp.contiguous()
        post = torch.empty((t, bsz), dtype=F32, device=device)
        hist = torch.empty((2, t, -(-bsz // 32) * 8 * 32), dtype=F32, device=device)
        rc = _build.load().srcdsp_bcjr(ls_c.data_ptr(), lp_c.data_ptr(), post.data_ptr(),
                                       hist.data_ptr(), t, bsz, int(terminated), c_mask,
                                       par_mask, _build.stream_handle(ls_c))
        _build.check(rc, "bcjr")
        _build.LAUNCHES["bcjr"] += 1
        return post

    return fn


def turbo_decode_pallas(tc: TurboCode, llr_sys: torch.Tensor, llr_par1: torch.Tensor,
                        llr_par2: torch.Tensor, iters: int = 6, b_tile: int = 128):
    """`turbo.turbo_decode_batch` with both BCJR halves as K16, on the
    inputs' device: llr_sys / llr_par1 [B, T+k-1], llr_par2 [B, T] ->
    (bits [B, T] int32, posterior [B, T]); B a multiple of b_tile."""
    t = llr_par2.shape[-1]
    kk = tc.rsc.k - 1
    dev = llr_sys.device
    bcjr1 = make_bcjr_kernel(tc.rsc, t + kk, True, b_tile=b_tile, device=dev)
    bcjr2 = make_bcjr_kernel(tc.rsc, t, False, b_tile=b_tile, device=dev)
    return turbo_iterations(tc, llr_sys, llr_par1, llr_par2, iters, bcjr1, bcjr2)
