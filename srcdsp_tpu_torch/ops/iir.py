"""IIR filters as exact block state-space matmuls (counterpart of
``srcdsp_tpu/ops/iir.py``).

The per-sample recurrence y[n] = b0 x[n] + ... - a1 y[n-1] - ... is removed
exactly, with no impulse-response truncation:

- (b, a) becomes controllable-canonical state space (A [p,p], B, C, D);
- for a block length L, a block's outputs are an affine function of its
  entry state s_k and its inputs x_k:

      y_k   = G s_k + H x_k          G [L,p]: rows C A^j
      s_k+1 = (A^L) s_k + F x_k      H [L,L]: lower-triangular Toeplitz of
                                       the exact impulse response h[0..L-1]
                                     F [p,L]: columns A^(L-1-i) B

  with H, G, F made once in float64 on the host and applied in float32;
- the surviving inter-block recurrence (K = N/L steps of a [p,p] matvec)
  runs as K sequential steps (``inter_block="scan"``) or, by default, as a
  log2(K)-round doubling scan of the affine pairs (``"assoc"``, written out
  here: torch has no ``associative_scan``). The two differ only in the
  association of the state path.

Every product runs in full float32 on the card (``ops.fir.pin_f32`` turns TF32
off), the port's form of the reference's ``Precision.HIGHEST``; the JAX
version's `precision` argument therefore has no counterpart. Cascaded
biquads (scipy-style SOS) apply one exact section after another.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import CF32, F32

__all__ = ["IirParams", "IirState", "make_iir_params", "iir_init", "iir_apply", "iir_full",
           "make_sos_params", "sos_init", "sos_apply", "dc_block_coeffs", "np_iir_full"]


@dataclasses.dataclass(frozen=True)
class IirParams:
    """Precomputed block state-space matrices for one section (float32
    tensors); block and order are Python ints."""

    al: torch.Tensor     # [p, p]  A^L
    f: torch.Tensor      # [p, L]  state injection: s+ = al @ s + f @ x_block
    g: torch.Tensor      # [L, p]  output from entry state
    h: torch.Tensor      # [L, L]  lower-triangular Toeplitz (exact impulse resp)
    block: int
    order: int


class IirState(NamedTuple):
    """Carried state vector (controllable-canonical coordinates)."""

    s: torch.Tensor      # [..., p] complex64


def _tf2ss(b: np.ndarray, a: np.ndarray) -> tuple[np.ndarray, ...]:
    """Controllable-canonical (A, B, C, D) in float64. a[0] must be != 0."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim != 1 or b.ndim != 1 or a.size < 2:
        raise ValueError("need 1-D b, a with len(a) >= 2")
    b = b / a[0]
    a = a / a[0]
    p = max(a.size, b.size) - 1
    a = np.concatenate([a, np.zeros(p + 1 - a.size)])
    b = np.concatenate([b, np.zeros(p + 1 - b.size)])
    A = np.zeros((p, p))
    A[0, :] = -a[1:]
    if p > 1:
        A[1:, :-1] = np.eye(p - 1)
    B = np.zeros(p)
    B[0] = 1.0
    C = b[1:] - b[0] * a[1:]
    D = b[0]
    return A, B, C, D


def make_iir_params(b: Sequence[float], a: Sequence[float], block: int = 128,
                    device=None) -> IirParams:
    """Block state-space matrices for the filter b(z)/a(z), inner block
    length `block`. Raises for unstable filters."""
    A, B, C, D = _tf2ss(np.asarray(b), np.asarray(a))
    p = A.shape[0]
    if np.max(np.abs(np.linalg.eigvals(A))) >= 1.0 - 1e-12:
        raise ValueError("unstable filter: spectral radius of A >= 1")
    L = int(block)
    if L < 1:
        raise ValueError(f"block must be >= 1, got {L}")
    pw = np.empty((L + 1, p, p))       # A^0 .. A^L (float64)
    pw[0] = np.eye(p)
    for j in range(1, L + 1):
        pw[j] = pw[j - 1] @ A
    F = np.stack([pw[L - 1 - i] @ B for i in range(L)], axis=1)   # [p, L]
    G = np.stack([C @ pw[j] for j in range(L)], axis=0)           # [L, p]
    h = np.empty(L)
    h[0] = D
    for j in range(1, L):
        h[j] = C @ pw[j - 1] @ B
    H = np.zeros((L, L))
    for i in range(L):
        H[i, : i + 1] = h[: i + 1][::-1]
    device = resolve(device)

    def t(m):
        return torch.as_tensor(m.astype(np.float32), device=device)

    return IirParams(al=t(pw[L]), f=t(F), g=t(G), h=t(H), block=L, order=p)


def iir_init(params: IirParams, channel_shape: tuple = (), dtype=CF32,
             device=None) -> IirState:
    """Zero state == filter at rest."""
    return IirState(s=torch.zeros((*channel_shape, params.order), dtype=dtype,
                                  device=resolve(device)))


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in `dtype`; a complex tensor cast to a real dtype keeps its real part."""
    if t.is_complex() and not dtype.is_complex:
        t = t.real
    return t.to(dtype)


def _doubling_scan(al: torch.Tensor, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the affine maps s -> al s + u_k over axis -2 of u
    [..., K, p], by log2(K) rounds of doubling: after the round of stride d,
    entry k composes the maps k-2d+1 .. k (later applied after earlier:
    (M2, v2) o (M1, v1) = (M2 M1, M2 v1 + v2)). Returns (M_cum [K, p, p],
    v_cum [..., K, p]): the state after map k is M_cum[k] s0 + v_cum[k]. The
    maps share one matrix, so M_cum does not depend on the leading axes."""
    k = u.shape[-2]
    m = al.expand(k, *al.shape).clone()
    v = u
    d = 1
    while d < k:
        v = torch.cat([v[..., :d, :],
                       (m[d:] @ v[..., :-d, :, None]).squeeze(-1) + v[..., d:, :]], dim=-2)
        m = torch.cat([m[:d], m[d:] @ m[:-d]], dim=0)
        d *= 2
    return m, v


def iir_apply(params: IirParams, state: IirState, x: torch.Tensor,
              inter_block: str = "assoc") -> tuple[IirState, torch.Tensor]:
    """Filter one block. x: [..., N] with N % params.block == 0.

    The inter-block recurrence s_{k+1} = al s_k + u_k runs as a doubling
    scan of (M, v) pairs (``"assoc"``, log2(K) rounds) or as K sequential
    [p, p] matvecs (``"scan"``); everything else is batched matmul."""
    L, p = params.block, params.order
    n = x.shape[-1]
    if n % L != 0:
        raise ValueError(f"block length {n} not divisible by L={L}")
    if inter_block not in ("assoc", "scan"):
        raise ValueError(f"inter_block must be 'assoc' or 'scan', got {inter_block!r}")
    pin_f32(x)
    k = n // L
    lead = x.shape[:-1]
    cd = x.dtype
    xb = x.reshape(*lead, k, L)
    u = xb @ params.f.T.to(cd)                           # [..., K, p]
    al = params.al.to(cd)
    s0 = _as(state.s, cd)
    if inter_block == "scan":
        s, entries = s0, []
        for kk in range(k):
            entries.append(s)
            s = s @ al.T + u[..., kk, :]
        s_entry = torch.stack(entries, dim=-2)           # [..., K, p]
        s_end_all = torch.cat([s_entry[..., 1:, :], s[..., None, :]], dim=-2)
    else:
        m_cum, v_cum = _doubling_scan(al, u)
        # state after block k: M_cum[k] s0 + v_cum[k]; at block entry, s0 first
        s_end_all = (m_cum @ s0[..., None, :, None]).squeeze(-1) + v_cum
        s_entry = torch.cat([s0[..., None, :], s_end_all[..., :-1, :]], dim=-2)
    y = s_entry @ params.g.T.to(cd) + xb @ params.h.T.to(cd)          # [..., K, L]
    return IirState(s=_as(s_end_all[..., -1, :], state.s.dtype)), y.reshape(*lead, n)


def iir_full(params: IirParams, x: torch.Tensor) -> torch.Tensor:
    """Whole-signal causal IIR from rest (one-shot convenience)."""
    st = iir_init(params, tuple(x.shape[:-1]), dtype=x.dtype, device=x.device)
    return iir_apply(params, st, x)[1]


# ---------- cascaded biquads (scipy-style SOS) ----------

def make_sos_params(sos: np.ndarray, block: int = 128, device=None) -> tuple[IirParams, ...]:
    """Per-section params for a scipy-style [K, 6] SOS array."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be [K, 6], got {sos.shape}")
    return tuple(make_iir_params(row[:3], row[3:], block=block, device=device) for row in sos)


def sos_init(params: Sequence[IirParams], channel_shape: tuple = (), dtype=CF32,
             device=None) -> tuple[IirState, ...]:
    return tuple(iir_init(p, channel_shape, dtype, device) for p in params)


def sos_apply(params: Sequence[IirParams], states: Sequence[IirState], x: torch.Tensor
              ) -> tuple[tuple[IirState, ...], torch.Tensor]:
    """Apply a biquad cascade (sections in sequence, each exact)."""
    new_states = []
    y = x
    for p, st in zip(params, states):
        st2, y = iir_apply(p, st, y)
        new_states.append(st2)
    return tuple(new_states), y


# ---------- conveniences ----------

def dc_block_coeffs(alpha: float = 0.995) -> tuple[np.ndarray, np.ndarray]:
    """First-order DC blocker: H(z) = (1 - z^-1) / (1 - alpha z^-1)."""
    return np.array([1.0, -1.0]), np.array([1.0, -float(alpha)])


def np_iir_full(b: np.ndarray, a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Sequential double-precision direct-form-II-transposed twin (tests)."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    b = b / a[0]
    a = a / a[0]
    p = max(a.size, b.size) - 1
    b = np.concatenate([b, np.zeros(p + 1 - b.size)])
    a = np.concatenate([a, np.zeros(p + 1 - a.size)])
    y = np.zeros(x.shape, np.complex128)
    z = np.zeros(x.shape[:-1] + (p,), np.complex128)
    for n in range(x.shape[-1]):
        xn = x[..., n]
        yn = b[0] * xn + z[..., 0]
        for j in range(p - 1):
            z[..., j] = b[j + 1] * xn + z[..., j + 1] - a[j + 1] * yn
        z[..., p - 1] = b[p] * xn - a[p] * yn
        y[..., n] = yn
    return y.astype(x.dtype)
