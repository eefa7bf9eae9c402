"""Digital predistortion (DPD) of a transmit power amplifier (counterpart of
``srcdsp_tpu/ops/dpd.py``): a baseband memory-polynomial predistorter
identified by indirect learning (ILA).

- The basis B[n, (k,m)] = x[n-m] |x[n-m]|^(k-1) (odd orders k, memory m,
  k-major columns) is built on the input's device.
- **Apply** sums the basis columns times the coefficients, one column at a
  time in column order and in real planes (the reference's one [N, C] x
  [C] product), without holding the basis: each output is the same
  fixed-order sum of its own row, so block-wise application equals the
  one-shot run bit for bit under any split, on any device (the reference's
  contract; a matrix-vector product, or torch's vectorized complex
  multiply, whose rounding differs between vector lanes and the scalar
  tail, would let the result depend on the block).
- **Identification** regresses the postdistorter mp(pa_out/gain) -> pa_in
  by ridge-regularised normal equations: the Gram B^H B and B^H z are
  matmuls with TF32 off (`ops.fir.pin_f32`), the [C, C] complex solve
  `torch.linalg.solve`.

The carried state is the memory-1 sample history (the T2 streaming
contract). `pa_saleh` and `pa_memory_polynomial` are PA models for tests and
demos.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from srcdsp_tpu_torch.device import as_tensor_on, resolve
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import CF32, F32

__all__ = [
    "mp_basis", "mp_num_coeffs", "pa_saleh", "pa_memory_polynomial",
    "DpdParams", "DpdState", "make_dpd_params", "dpd_init", "dpd_apply",
    "dpd_full", "dpd_identify_ila", "dpd_train_ila", "lin_gain_ls",
]


def _check_order_memory(order: int, memory: int) -> tuple[int, int]:
    if order < 1 or order % 2 == 0:
        raise ValueError(f"order must be odd and >= 1, got {order}")
    if memory < 1:
        raise ValueError(f"memory must be >= 1, got {memory}")
    return order, memory


def mp_num_coeffs(order: int, memory: int) -> int:
    """Number of memory-polynomial coefficients: (order+1)//2 * memory."""
    order, memory = _check_order_memory(order, memory)
    return ((order + 1) // 2) * memory


def _columns(x: torch.Tensor, order: int, memory: int, history):
    """The basis columns of mp_basis, k-major, one at a time: (re, im) float32
    planes of x[n-m] |x[n-m]|^(k-1), the envelope a running product of
    |x|^2 from 1 as in the reference, its product with the complex sample
    taken per plane (the product by a real envelope, with no rounding of a
    zero imaginary part)."""
    if history is None:
        history = torch.zeros((*x.shape[:-1], memory - 1), dtype=CF32, device=x.device)
    xh = torch.cat([torch.as_tensor(history, dtype=CF32, device=x.device), x], dim=-1)
    n = x.shape[-1]
    for ki in range((order + 1) // 2):
        for m in range(memory):
            xd = xh[..., memory - 1 - m: memory - 1 - m + n]
            mag2 = xd.real ** 2 + xd.imag ** 2
            env = torch.ones_like(mag2)
            for _ in range(ki):
                env = env * mag2
            yield xd.real * env, xd.imag * env


def mp_basis(x, order: int, memory: int, history=None, device=None) -> torch.Tensor:
    """Memory-polynomial basis matrix for one block.

    x: [..., N] complex (a tensor stays on its device, anything else goes to
    `device`, None = the card). history: [..., memory-1] samples preceding
    the block (zeros from rest when None). Returns [..., N, C], C =
    mp_num_coeffs(order, memory); column (k, m), k-major over the odd
    orders 1, 3, ..., order and m = 0..memory-1, is x[n-m] |x[n-m]|^(k-1)."""
    order, memory = _check_order_memory(order, memory)
    x = as_tensor_on(x, device, CF32)
    return torch.stack([torch.complex(re, im) for re, im in _columns(x, order, memory, history)],
                       dim=-1)


def _combine(x: torch.Tensor, order: int, memory: int, history, coeffs: torch.Tensor
             ) -> torch.Tensor:
    """sum_c basis[..., c] * coeffs[c], accumulated in column order in real
    planes (each product and sum its own rounding, the same on any device
    and at any vector position), with no basis matrix held."""
    cr, ci = coeffs.real, coeffs.imag
    yr = yi = None
    for c, (br, bi) in enumerate(_columns(x, order, memory, history)):
        pr, pi = br * cr[c] - bi * ci[c], br * ci[c] + bi * cr[c]
        yr, yi = (pr, pi) if yr is None else (yr + pr, yi + pi)
    return torch.complex(yr, yi)


# ---------- PA fixture models ----------

def pa_saleh(x, alpha_a: float = 2.1587, beta_a: float = 1.1517,
             alpha_p: float = 4.0033, beta_p: float = 9.1040, device=None) -> torch.Tensor:
    """Saleh memoryless TWT model: AM/AM r -> a_a r/(1+b_a r^2), AM/PM
    phase shift a_p r^2/(1+b_p r^2). Defaults are Saleh's published fit."""
    x = as_tensor_on(x, device, CF32)
    r2 = x.real ** 2 + x.imag ** 2
    gain = alpha_a / (1.0 + beta_a * r2)
    phi = (alpha_p * r2 / (1.0 + beta_p * r2)).to(F32)
    return (x * gain * torch.exp(1j * phi)).to(CF32)


def pa_memory_polynomial(coeffs, order: int, memory: int, x, device=None) -> torch.Tensor:
    """Evaluate a memory-polynomial PA from rest: basis times coeffs."""
    order, memory = _check_order_memory(order, memory)
    x = as_tensor_on(x, device, CF32)
    return _combine(x, order, memory, None, torch.as_tensor(coeffs, dtype=CF32, device=x.device))


# ---------- predistorter op (T2 streaming contract) ----------

class DpdParams(NamedTuple):
    order: int              # static: max odd order
    memory: int             # static: memory depth (taps)
    coeffs: torch.Tensor    # [C] complex64, C = mp_num_coeffs(order, memory)


class DpdState(NamedTuple):
    history: torch.Tensor   # [..., memory-1] complex64 carried input tail


def make_dpd_params(order: int, memory: int, coeffs=None, device=None) -> DpdParams:
    """Identity predistorter unless coeffs given (c[0] = 1 passes x[n]); a
    coeffs tensor stays on its device, anything else goes to `device` (None
    = the card)."""
    c_n = mp_num_coeffs(order, memory)
    if coeffs is None:
        coeffs = torch.zeros(c_n, dtype=CF32, device=resolve(device))
        coeffs[0] = 1.0
    coeffs = as_tensor_on(coeffs, device, CF32)
    if tuple(coeffs.shape) != (c_n,):
        raise ValueError(f"coeffs must be [{c_n}], got {tuple(coeffs.shape)}")
    return DpdParams(order=order, memory=memory, coeffs=coeffs)


def dpd_init(params: DpdParams, channel_shape: tuple = ()) -> DpdState:
    return DpdState(history=torch.zeros((*channel_shape, params.memory - 1), dtype=CF32,
                                        device=params.coeffs.device))


def dpd_apply(params: DpdParams, state: DpdState, x) -> tuple[DpdState, torch.Tensor]:
    """Predistort one block x [..., N] (N >= memory-1; a non-tensor block goes
    to the params' device); the output equals the one-shot run bit for bit
    under any block split."""
    x = as_tensor_on(x, params.coeffs.device, CF32)
    y = _combine(x, params.order, params.memory, state.history, params.coeffs)
    m = params.memory - 1
    if m:
        xh = torch.cat([state.history, x], dim=-1)
        hist = xh[..., xh.shape[-1] - m:]
    else:
        hist = state.history
    return DpdState(history=hist), y


def dpd_full(params: DpdParams, x) -> torch.Tensor:
    """Whole-signal convenience (from rest)."""
    x = as_tensor_on(x, params.coeffs.device, CF32)
    _, y = dpd_apply(params, dpd_init(params, tuple(x.shape[:-1])), x)
    return y


# ---------- identification ----------

def lin_gain_ls(x, y, device=None) -> torch.Tensor:
    """Complex LS scalar g minimizing ||y - g x||^2 (the PA's linear gain
    when y = PA(x) and the drive is mostly in the linear region)."""
    x = as_tensor_on(x, device, CF32).reshape(-1)
    y = as_tensor_on(y, x.device, CF32).reshape(-1)
    return torch.vdot(x, y) / torch.clamp(torch.vdot(x, x).real, min=1e-30)


def dpd_identify_ila(pa_in, pa_out, order: int, memory: int, gain,
                     ridge: float = 1e-9, device=None) -> torch.Tensor:
    """One indirect-learning fit: regress the postdistorter
    mp(pa_out/gain) -> pa_in by regularized normal equations (the Gram
    B^H B and B^H z with TF32 off, then a [C, C] complex solve). Returns [C]
    coefficients for the predistorter on the inputs' device."""
    z = as_tensor_on(pa_in, device, CF32).reshape(-1)
    y = as_tensor_on(pa_out, z.device, CF32).reshape(-1)
    g = torch.as_tensor(gain, dtype=CF32, device=z.device)
    b = mp_basis(y / g, order, memory)
    pin_f32(b)
    bh = b.conj().T
    gram = bh @ b
    rhs = bh @ z
    eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
    scale = torch.clamp(torch.diagonal(gram).sum().real / gram.shape[0], min=1e-30)
    return torch.linalg.solve(gram + (ridge * scale) * eye, rhs)


def dpd_train_ila(pa_fn: Callable[[torch.Tensor], torch.Tensor], x, order: int,
                  memory: int, iters: int = 2, gain=None, device=None
                  ) -> tuple[DpdParams, torch.Tensor]:
    """Iterate ILA against a PA (model or measurement callback): start from
    the identity predistorter, alternate {drive PA, refit postdistorter, copy
    in front}. Returns (params, linear gain used); gain=None estimates it
    from the first (identity) drive by LS."""
    x = as_tensor_on(x, device, CF32)
    params = make_dpd_params(order, memory, device=x.device)
    g = None if gain is None else torch.as_tensor(gain, dtype=CF32, device=x.device)
    for _ in range(max(1, int(iters))):
        z = dpd_full(params, x)
        y = pa_fn(z)
        if g is None:
            g = lin_gain_ls(z, y)
        c = dpd_identify_ila(z, y, order, memory, g)
        params = params._replace(coeffs=c.to(CF32))
    return params, g
