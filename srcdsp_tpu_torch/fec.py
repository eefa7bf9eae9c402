"""Convolutional FEC: encoder + Viterbi decoder (counterpart of
``srcdsp_tpu/fec.py``).

- Code tables are built on the host (the reference's numpy, so they are
  equal) and moved to the data's device per call.
- The encoder is a binary FIR over the bits: out[t, j] = XOR of
  u[t - i] over the taps of g_j, in integer XORs of shifted bits (no
  convolution, so no TF32 and no rounding on any device).
- Viterbi: the branch metrics of every step and edge are formed before the
  recursion, in float32 as products by the +-1 expected symbols summed in
  generator order (elementwise, so TF32 cannot touch them); the
  add-compare-select is a loop over trellis steps on the [B, S] path
  metrics, batched over codewords; the choice of each pair is
  ``cand[..., 1] > cand[..., 0]`` (the reference's argmax returns the first
  maximum: ties, frequent with hard or integer inputs, pick 0); the metrics
  are renormalized by subtracting their maximum; the traceback is a reverse
  loop over the stored decisions. Neither loop reads anything back to the
  host.

Conventions (NASA/CCSDS): generator g_j is a K-bit integer whose MSB taps
the current input bit; decoder state s = the previous K-1 input bits,
newest in the MSB; BPSK bit b -> 1 - 2b; soft inputs are correlation
metrics (positive = bit 0); punctured positions are soft zeros.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from srcdsp_tpu_torch.types import F32

I32 = torch.int32


class ConvCode(NamedTuple):
    """Static host tables of one rate-1/n convolutional code."""

    k: int                 # constraint length
    n: int                 # output bits per input bit (rate 1/n)
    gens: tuple            # generator polynomials (K-bit ints, MSB = current bit)
    taps: np.ndarray       # [n, K] f32 0/1, taps[j, i] = does g_j tap u[t-i]
    exp_pm1: np.ndarray    # [n, 2S] f32 +-1 expected symbols per edge e = s*2 + b
    prev: np.ndarray       # [S, 2] i32 predecessor states of each new state
    prev_edge: np.ndarray  # [S, 2] i32 edge index (s_prev*2 + b_new) per choice


def make_conv_code(k: int, gens: Sequence[int]) -> ConvCode:
    """Tables for constraint length `k` and generators `gens` (integers, e.g.
    octal 0o133; each fits in k bits). K=7 rate 1/2 NASA code:
    ``make_conv_code(7, (0o133, 0o171))``."""
    gens = tuple(int(g) for g in gens)
    if k < 2 or k > 16:
        raise ValueError("constraint length must be in [2, 16]")
    for g in gens:
        if not 0 < g < (1 << k):
            raise ValueError(f"generator {g:o} does not fit in {k} bits")
    n = len(gens)
    s_count = 1 << (k - 1)
    taps = np.zeros((n, k), np.float32)
    for j, g in enumerate(gens):
        for i in range(k):
            taps[j, i] = (g >> (k - 1 - i)) & 1
    # edge e = (s, b): register r = (b << (k-1)) | s; output j = parity(r & g_j)
    exp = np.zeros((n, 2 * s_count), np.float32)
    for s in range(s_count):
        for b in (0, 1):
            r = (b << (k - 1)) | s
            for j, g in enumerate(gens):
                bit = bin(r & g).count("1") & 1
                exp[j, s * 2 + b] = 1.0 - 2.0 * bit
    # predecessors of s': the new input bit is the MSB of s'
    low_mask = (s_count >> 1) - 1 if k > 2 else 0
    prev = np.zeros((s_count, 2), np.int32)
    prev_edge = np.zeros((s_count, 2), np.int32)
    for sp in range(s_count):
        b_new = sp >> (k - 2)
        low = sp & low_mask
        for i in (0, 1):
            s_prev = (low << 1) | i
            prev[sp, i] = s_prev
            prev_edge[sp, i] = s_prev * 2 + b_new
    return ConvCode(k=k, n=n, gens=gens, taps=taps, exp_pm1=exp, prev=prev,
                    prev_edge=prev_edge)


def conv_encode(code: ConvCode, bits: torch.Tensor, terminate: bool = True) -> torch.Tensor:
    """Encode bits [..., T] (0/1) -> coded bits [..., n*(T+tail)] int32.

    Per input bit the n generator outputs are adjacent (g_0 first).
    `terminate` appends k-1 zeros so the encoder ends in state 0.
    """
    u = bits.to(I32)
    lead = tuple(u.shape[:-1])
    t_in = u.shape[-1] + (code.k - 1 if terminate else 0)
    # zeros before t = 0 (the register starts clear) and the k-1 tail zeros
    up = F.pad(u, (code.k - 1, t_in - u.shape[-1]))
    outs = []
    for j in range(code.n):
        acc = torch.zeros(lead + (t_in,), dtype=I32, device=u.device)
        for i in range(code.k):
            if code.taps[j, i]:
                acc = torch.bitwise_xor(acc, up[..., code.k - 1 - i: code.k - 1 - i + t_in])
        outs.append(acc)
    return torch.stack(outs, dim=-1).reshape(*lead, t_in * code.n)


def bpsk_soft(coded_bits: torch.Tensor, generator: torch.Generator | None = None,
              noise_std: float = 0.0) -> torch.Tensor:
    """Map coded bits to +-1 BPSK soft symbols (bit 0 -> +1), plus AWGN drawn
    from `generator` (a torch.Generator on the bits' device) when noise_std > 0."""
    s = 1.0 - 2.0 * coded_bits.to(F32)
    if generator is not None and noise_std > 0.0:
        s = s + noise_std * torch.randn(s.shape, generator=generator, dtype=F32,
                                        device=s.device)
    return s


def depuncture(soft: torch.Tensor, pattern: Sequence[int]) -> torch.Tensor:
    """Re-insert erasures (soft 0) at punctured positions.

    `pattern` is the transmit mask over one period (1 = sent); `soft` holds
    the sent values [..., T_sent], a whole number of periods. Returns
    [..., T_full] with zeros at the punctured slots.
    """
    pat = np.asarray(pattern, np.int32)
    per, sent_per = pat.size, int(pat.sum())
    lead = tuple(soft.shape[:-1])
    t_sent = soft.shape[-1]
    if t_sent % sent_per:
        raise ValueError("punctured length must be a whole number of periods")
    periods = t_sent // sent_per
    full = torch.zeros(lead + (periods, per), dtype=soft.dtype, device=soft.device)
    idx = torch.as_tensor(np.nonzero(pat)[0], device=soft.device)
    full[..., idx] = soft.reshape(lead + (periods, sent_per))
    return full.reshape(lead + (periods * per,))


def puncture(coded: torch.Tensor, pattern: Sequence[int]) -> torch.Tensor:
    """Keep only positions where `pattern` (tiled) is 1. [..., T] -> [..., T_sent]."""
    pat = np.asarray(pattern, np.int32)
    per = pat.size
    lead = tuple(coded.shape[:-1])
    t = coded.shape[-1]
    if t % per:
        raise ValueError("coded length must be a whole number of periods")
    idx = torch.as_tensor(np.nonzero(pat)[0], device=coded.device)
    return coded.reshape(lead + (t // per, per))[..., idx].reshape(lead + (t // per * idx.numel(),))


def branch_metrics(code: ConvCode, r: torch.Tensor) -> torch.Tensor:
    """r [B, T, n] float32 -> metrics [B, T, S, 2] of the two edges into each
    state: sum_j r[..., j] * exp_pm1[j, prev_edge] in generator order, each
    product by +-1 exact, so one rounding per add and no matmul."""
    exp_g = torch.as_tensor(code.exp_pm1[:, code.prev_edge], device=r.device)   # [n, S, 2]
    bm = r[..., 0, None, None] * exp_g[0]
    for j in range(1, code.n):
        bm = bm + r[..., j, None, None] * exp_g[j]
    return bm


def viterbi_decode(code: ConvCode, soft: torch.Tensor, terminated: bool = True) -> torch.Tensor:
    """Maximum-likelihood decode of soft symbols [..., n*T] -> bits [..., T_info] int32.

    With `terminated`, the traceback starts from state 0 and the last k-1
    (tail) bits are stripped; else it starts from the best final state
    (the first of equals).
    """
    soft = soft.to(F32)
    lead = tuple(soft.shape[:-1])
    if soft.shape[-1] % code.n:
        raise ValueError("soft length must be a multiple of n")
    t_steps = soft.shape[-1] // code.n
    if terminated and t_steps <= code.k - 1:
        raise ValueError("terminated block shorter than the tail")
    dev = soft.device
    r = soft.reshape(-1, t_steps, code.n)               # [B, T, n]
    b_dim = r.shape[0]
    s_count = 1 << (code.k - 1)
    prev = torch.as_tensor(code.prev.astype(np.int64), device=dev)      # [S, 2]

    bm = branch_metrics(code, r)                        # [B, T, S, 2]

    # add-compare-select; path metrics start pinned to state 0
    pm = torch.full((b_dim, s_count), -1e30, dtype=F32, device=dev)
    pm[:, 0] = 0.0
    choices = torch.empty((t_steps, b_dim, s_count), dtype=torch.bool, device=dev)
    for t in range(t_steps):
        cand = pm[:, prev] + bm[:, t]                   # [B, S, 2]
        c0, c1 = cand[..., 0], cand[..., 1]
        torch.gt(c1, c0, out=choices[t])                # first maximum on ties
        pm = torch.maximum(c0, c1)
        pm = pm - pm.amax(dim=-1, keepdim=True)

    # traceback: the bit decided at step t is the MSB of the state after it
    state = (torch.zeros(b_dim, dtype=torch.int64, device=dev) if terminated
             else torch.argmax(pm, dim=-1))
    prev_flat = prev.reshape(-1)
    states = torch.empty((t_steps, b_dim), dtype=torch.int64, device=dev)
    for t in range(t_steps - 1, -1, -1):
        states[t] = state
        d = choices[t].gather(1, state[:, None])[:, 0]
        state = prev_flat[state * 2 + d]
    bits = (states >> (code.k - 2)).T                   # [B, T]
    if terminated:
        bits = bits[:, : t_steps - (code.k - 1)]
    return bits.reshape(lead + (bits.shape[-1],)).to(I32)


def viterbi_decode_hard(code: ConvCode, hard_bits: torch.Tensor,
                        terminated: bool = True) -> torch.Tensor:
    """Hard-decision decode: 0/1 coded bits -> info bits (Hamming metric)."""
    return viterbi_decode(code, 1.0 - 2.0 * hard_bits.to(F32), terminated=terminated)
