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

The CUDA kernel is ``csrc/bcjr.cu``. On a CPU tensor the wrapper runs the
plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.mixfir import check_f32_operand
from srcdsp_tpu_torch.turbo import RscCode, TurboCode, bcjr_decode_batch, turbo_iterations
from srcdsp_tpu_torch.types import F32


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
    device = resolve(device)
    # the trellis passes by value: next and previous states for inputs 0, 1
    tables = np.concatenate([code.next_state[:, 0], code.next_state[:, 1],
                             code.prev_state[:, 0], code.prev_state[:, 1]]).astype(np.int32)
    sg = (1 - 2 * par[:, 0]).astype(np.float32)

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
        betas = torch.empty((t, bsz, 8), dtype=F32, device=device)
        rc = _build.load().srcdsp_bcjr(ls_c.data_ptr(), lp_c.data_ptr(), post.data_ptr(),
                                       betas.data_ptr(), t, bsz, int(terminated),
                                       tables.ctypes.data, sg.ctypes.data,
                                       _build.stream_handle(ls_c))
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
