"""Turbo codec: RSC encoders, max-log BCJR and iterative decoding
(counterpart of ``srcdsp_tpu/turbo.py``).

- `make_rsc` builds the constituent code's trellis tables on the host (the
  reference's numpy, so the tables are equal); `rsc_encode` steps the
  register over time (a Python loop over steps, batched over leading axes),
  with the feedback-driven tail that returns it to zero.
- `bcjr_decode_batch` is the plain max-log BCJR in the lane-native [T, B]
  layout and the plain version of kernel K16 (``kernels/bcjr_pallas.py``):
  the reference's `lax.scan`s become Python loops over time steps, with the
  same association per element. The recurrences carry the NORMALIZED metric;
  the posterior reads the UN-normalized step outputs, as the reference does.
  `bcjr_decode` is the one-codeword form.
- `turbo_decode_batch` iterates two BCJRs exchanging extrinsic LLRs through
  the interleaver; constituent 1 is tail-terminated, constituent 2 open.

LLR convention: positive favours bit 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.types import F32

NEG = -1e30   # finite "minus infinity" of the state metrics (float32 -1e30)


class RscCode(NamedTuple):
    """Static tables of one rate-1/2 RSC constituent code (host numpy).

    k: constraint length; S = 2^(k-1) states = register contents, most recent
    feedback bit in the MSB. fb/g: feedback / forward polynomials.
    """

    k: int
    fb: int
    g: int
    next_state: np.ndarray   # [S, 2] int32 state after input bit u
    parity: np.ndarray       # [S, 2] int32 parity bit emitted
    tail_bit: np.ndarray     # [S] int32 input that zeroes the feedback
    prev_state: np.ndarray   # [S, 2] int32 predecessor of s' for input u
    prev_parity: np.ndarray  # [S, 2] int32 parity on that edge


def make_rsc(k: int = 4, fb: int = 0o13, g: int = 0o15) -> RscCode:
    """Defaults are the 3GPP/LTE constituent code (K=4, 1 + D + D^3
    feedback, 1 + D^2 + D^3 forward)."""
    s_count = 1 << (k - 1)
    nxt = np.zeros((s_count, 2), np.int64)
    par = np.zeros((s_count, 2), np.int64)
    tail = np.zeros(s_count, np.int64)

    def reg_bits(s):
        return [(s >> (k - 2 - i)) & 1 for i in range(k - 1)]

    for s in range(s_count):
        r = reg_bits(s)
        fb_reg = 0
        for i in range(1, k):
            if (fb >> (k - 1 - i)) & 1:
                fb_reg ^= r[i - 1]
        tail[s] = fb_reg
        for u in (0, 1):
            a = u ^ fb_reg
            p = a if (g >> (k - 1)) & 1 else 0
            for i in range(1, k):
                if (g >> (k - 1 - i)) & 1:
                    p ^= r[i - 1]
            par[s, u] = p
            nxt[s, u] = (a << (k - 2)) | (s >> 1)
    prev = np.zeros((s_count, 2), np.int64)
    prev_par = np.zeros((s_count, 2), np.int64)
    for s in range(s_count):
        for u in (0, 1):
            prev[nxt[s, u], u] = s
            prev_par[nxt[s, u], u] = par[s, u]
    return RscCode(k=k, fb=fb, g=g, next_state=nxt.astype(np.int32),
                   parity=par.astype(np.int32), tail_bit=tail.astype(np.int32),
                   prev_state=prev.astype(np.int32), prev_parity=prev_par.astype(np.int32))


def rsc_encode(code: RscCode, bits, terminate: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode bits [..., T] of {0,1} (a tensor or array). Returns (systematic,
    parity) int32 [..., T(+k-1)]; with terminate=True the k-1 tail inputs that
    return the register to zero are appended to both streams."""
    u = torch.as_tensor(bits).to(torch.int64)
    dev = u.device
    nxt = torch.as_tensor(code.next_state, dtype=torch.int64, device=dev)
    par = torch.as_tensor(code.parity, dtype=torch.int64, device=dev)
    tail = torch.as_tensor(code.tail_bit, dtype=torch.int64, device=dev)
    s = torch.zeros(u.shape[:-1], dtype=torch.int64, device=dev)
    sys_b, par_b = [], []
    for t in range(u.shape[-1]):
        ut = u[..., t]
        sys_b.append(ut)
        par_b.append(par[s, ut])
        s = nxt[s, ut]
    if terminate:
        for _ in range(code.k - 1):
            ut = tail[s]
            sys_b.append(ut)
            par_b.append(par[s, ut])
            s = nxt[s, ut]
    return (torch.stack(sys_b, dim=-1).to(torch.int32),
            torch.stack(par_b, dim=-1).to(torch.int32))


def bcjr_decode_batch(code: RscCode, llr_sys: torch.Tensor, llr_par: torch.Tensor,
                      la: torch.Tensor | None = None, terminated: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K16: batched max-log BCJR, [T, B] inputs, metrics carried as
    [S, B]. Returns (posterior [T, B], extrinsic [T, B]) float32.

    Branch metric gamma[t, s, b2] = 0.5*ls*(1-2*b2) + 0.5*lp*(1-2*par[s, b2]);
    alpha'[s'] = max_b2 alpha[prev[s', b2]] + gamma[t, prev[s', b2], b2] and
    beta'[s] = max_b2 gamma[t, s, b2] + beta[next[s, b2]], each carried
    normalized (minus its max over states), the un-normalized step output
    kept for the posterior max_s (alpha + gamma) + beta[next].
    """
    s_count = 1 << (code.k - 1)
    dev = llr_sys.device
    ls = (llr_sys if la is None else llr_sys + la).to(F32)        # [T, B]
    lp = llr_par.to(F32)
    t_len, b = ls.shape
    sg = torch.as_tensor(1 - 2 * code.parity, dtype=F32, device=dev)   # [S, 2]
    bsign = torch.tensor([1.0, -1.0], dtype=F32, device=dev)
    # gamma [T, S, 2, B]
    gam = ((0.5 * ls)[:, None, None, :] * bsign[None, None, :, None]
           + (0.5 * lp)[:, None, None, :] * sg[None, :, :, None])
    nxt = torch.as_tensor(code.next_state, dtype=torch.int64, device=dev)
    prev = torch.as_tensor(code.prev_state, dtype=torch.int64, device=dev)
    two = torch.arange(2, device=dev)

    a0 = torch.full((s_count, b), NEG, dtype=F32, device=dev)
    a0[0] = 0.0
    alphas = [a0]
    alpha = a0
    for t in range(t_len - 1):
        cand = alpha[prev] + gam[t][prev, two[None, :]]            # [S, 2, B]
        nalpha = torch.maximum(cand[:, 0], cand[:, 1])
        alphas.append(nalpha)
        alpha = nalpha - torch.amax(nalpha, dim=0, keepdim=True)
    bn = a0 if terminated else torch.zeros((s_count, b), dtype=F32, device=dev)
    betas = [bn]
    beta = bn
    for t in range(t_len - 1, 0, -1):
        cand = gam[t] + beta[nxt]                                  # [S, 2, B]
        nbeta = torch.maximum(cand[:, 0], cand[:, 1])
        betas.append(nbeta)
        beta = nbeta - torch.amax(nbeta, dim=0, keepdim=True)
    alphas = torch.stack(alphas)                                   # alpha before t
    betas = torch.stack(betas[::-1])                               # beta after t
    metric = (alphas[:, :, None, :] + gam) + betas[:, nxt]         # [T, S, 2, B]
    post = torch.amax(metric[:, :, 0], dim=1) - torch.amax(metric[:, :, 1], dim=1)
    return post, post - ls


def bcjr_decode(code: RscCode, llr_sys: torch.Tensor, llr_par: torch.Tensor,
                la: torch.Tensor | None = None, terminated: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """max-log BCJR over one codeword: llr_sys / llr_par / la [T] ->
    (posterior [T], extrinsic [T]), `bcjr_decode_batch` at B = 1."""
    post, ext = bcjr_decode_batch(code, llr_sys[:, None], llr_par[:, None],
                                  None if la is None else la[:, None], terminated)
    return post[:, 0], ext[:, 0]


class TurboCode(NamedTuple):
    rsc: RscCode
    perm: np.ndarray       # [T] interleaver (info positions)


def make_turbo(block_len: int, seed: int = 0, k: int = 4, fb: int = 0o13,
               g: int = 0o15) -> TurboCode:
    rng = np.random.default_rng(seed)
    return TurboCode(rsc=make_rsc(k, fb, g), perm=rng.permutation(block_len).astype(np.int64))


def turbo_encode(tc: TurboCode, bits):
    """Rate ~1/3 over bits [..., T]: (systematic + tail [..., T+k-1],
    parity1 [..., T+k-1], parity2 [..., T] of the interleaved bits,
    unterminated)."""
    u = torch.as_tensor(bits)
    sys1, par1 = rsc_encode(tc.rsc, u, terminate=True)
    _, par2 = rsc_encode(tc.rsc, u[..., torch.as_tensor(tc.perm, device=u.device)],
                         terminate=False)
    return sys1, par1, par2


def turbo_iterations(tc: TurboCode, llr_sys: torch.Tensor, llr_par1: torch.Tensor,
                     llr_par2: torch.Tensor, iters: int, bcjr1, bcjr2):
    """The turbo loop over [B, T(+k-1)] LLRs with the two BCJR halves given
    as bcjr(ls_tot [T, B], lp [T, B]) -> posterior [T, B]. Returns
    (bits [B, T] int32, posterior [B, T])."""
    t = llr_par2.shape[-1]
    kk = tc.rsc.k - 1
    dev = llr_sys.device
    perm = torch.as_tensor(tc.perm, device=dev)
    inv = torch.argsort(perm)
    s1 = llr_sys.T.to(F32)                             # [T+kk, B]
    p1 = llr_par1.T.to(F32)
    p2 = llr_par2.T.to(F32)
    sys2 = s1[:t][perm]
    zeros_tail = torch.zeros((kk, s1.shape[-1]), dtype=F32, device=dev)
    ext2 = torch.zeros((t, s1.shape[-1]), dtype=F32, device=dev)
    post = ext2
    for _ in range(iters):
        ls1 = s1 + torch.cat([ext2, zeros_tail])
        ext1 = bcjr1(ls1, p1) - ls1
        ls2 = sys2 + ext1[:t][perm]
        post2 = bcjr2(ls2, p2)
        ext2 = (post2 - ls2)[inv]
        post = post2[inv]
    post = post.T
    return (post < 0).to(torch.int32), post


def turbo_decode_batch(tc: TurboCode, llr_sys: torch.Tensor, llr_par1: torch.Tensor,
                       llr_par2: torch.Tensor, iters: int = 6):
    """Batched turbo decode over the plain BCJR: llr_sys / llr_par1
    [B, T+k-1], llr_par2 [B, T] -> (bits [B, T] int32, posterior [B, T])."""
    return turbo_iterations(
        tc, llr_sys, llr_par1, llr_par2, iters,
        lambda ls, lp: bcjr_decode_batch(tc.rsc, ls, lp, terminated=True)[0],
        lambda ls, lp: bcjr_decode_batch(tc.rsc, ls, lp, terminated=False)[0])


def turbo_decode(tc: TurboCode, llr_sys: torch.Tensor, llr_par1: torch.Tensor,
                 llr_par2: torch.Tensor, iters: int = 6):
    """One codeword: llr_sys / llr_par1 [T+k-1], llr_par2 [T] -> (bits [T]
    int32, posterior [T])."""
    bits, post = turbo_decode_batch(tc, llr_sys[None], llr_par1[None], llr_par2[None], iters)
    return bits[0], post[0]
