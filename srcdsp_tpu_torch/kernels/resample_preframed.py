"""Pre-framed mix + L/M resampler, kernel K9 (counterpart of
``srcdsp_tpu/kernels/resample_preframed.py``).

A producer ships [NT, span] frames: row r holds the stream's samples
[r*stride, r*stride + span) with stride = out_tile*down/up and span = stride
+ hist (K6 ``kernels/mixfir_preframed.make_frame_kernel``, `frame_planes`,
or the ingest framer), so each output row reads one frame row and the kernel
does no window work of its own.

The TPU kernel folds the NCO into complex bands (`banded_resample_ctaps`)
and keeps one phasor per output row, to keep the per-sample mix off its
vector unit. On the card that fold would double the FMAs per tap (complex x
complex instead of real x complex) to save one sincospif per staged sample,
so the CUDA kernel does not fold: it is K8's body (``csrc/resample.cu``) with
the frames as its window source, and gives K8's bits on the same stream. The
plain version rebuilds the stream from the frames and runs K8's plain
version, so the two plain versions are bit-identical too. Against the JAX
kernel the contract is the reference's own between its two tiers, SNR >
100 dB.

bf16 ingest (``in_dtype=torch.bfloat16``): frames ship as bf16 and are
converted to f32 once at staging; taps, sums and outputs stay f32 (the JAX
variant also rounds its bands to bf16, a constraint of its matrix unit), held
to the reference's gate, SNR > 40 dB against the f32 output.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.mixfir import check_in_dtype, cuda_or_cpu
from srcdsp_tpu_torch.kernels.mixfir_ctaps import word_u32
from srcdsp_tpu_torch.kernels.mixfir_preframed import _frame_geometry, check_frames, deframe
from srcdsp_tpu_torch.kernels.resample_pallas import (
    mix_resample_plain, phase_taps, resample_geometry, toeplitz_resample)
from srcdsp_tpu_torch.ops.nco import TWO_PI, _INV_SCALE

__all__ = ["banded_resample_ctaps", "make_resample_preframed_kernel",
           "resample_preframed_plain"]


def banded_resample_ctaps(taps, dword: int, up: int, down: int, out_tile: int, hist: int,
                          block_cols: int) -> np.ndarray:
    """The TPU kernel's complex-folded stride-L bands [NB, bspan, 3*BC]:
    H[a, j] = h[j*down + hist*up - a*up] times e^{+j*dth*a}, packed
    [Gr | Gi+Gr | Gi-Gr] for its 3-matmul Gauss form. Host code, kept
    bit-equal to the JAX package's for the tests; the CUDA kernel does not
    use it."""
    ht = toeplitz_resample(np.asarray(taps, np.float64), up, down,
                           out_tile, hist).astype(np.float64)
    span = ht.shape[0]
    dth = TWO_PI * (np.uint32(dword) * _INV_SCALE)
    fold = np.exp(1j * dth * np.arange(span))[:, None]
    hc = ht * fold
    gr = hc.real.astype(np.float32)
    gi = hc.imag.astype(np.float32)
    nb = out_tile // block_cols
    blk_stride = (block_cols * down) // up
    bspan = blk_stride + hist
    bands = []
    for j in range(nb):
        rs = slice(j * blk_stride, j * blk_stride + bspan)
        cs = slice(j * block_cols, (j + 1) * block_cols)
        r, i = gr[rs, cs], gi[rs, cs]
        bands.append(np.concatenate([r, i + r, i - r], axis=1))
    return np.stack(bands)


def resample_preframed_plain(word0, dword: int, xr_f: torch.Tensor, xi_f: torch.Tensor,
                             taps, up: int, down: int, out_tile: int, hist: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K9: the stream rebuilt from frames [NT, span], then K8's
    plain version -> yr, yi [NT, OT] f32."""
    stride = (out_tile * down) // up
    x = torch.stack([deframe(xr_f, stride), deframe(xi_f, stride)])[None]
    yr, yi = mix_resample_plain(word0, dword, x, taps, up, down, out_tile, hist)
    return yr[0], yi[0]


def make_resample_preframed_kernel(taps, dword: int, up: int, down: int, out_tile: int = 768,
                                   b_rows: int = 16, in_dtype: torch.dtype = torch.float32,
                                   device=None):
    """K9 over producer frames. Returns (fn, hist, stride, span) with
    fn(word0, xr_f [NT, span], xi_f [NT, span]) -> (yr, yi) [NT, out_tile] f32.

    word0 is the phase word at the first history sample, K8's word0; the
    tuning word `dword` is fixed here. NT must be a multiple of b_rows, and
    the frame geometry needs hist | stride (out_tile a multiple of 192 at the
    config-2 combined taps). The TPU version's block_cols, precision and
    interpret options shape only the Pallas lowering.
    """
    bf16 = check_in_dtype(in_dtype)
    counter = "resample_preframed_bf16" if bf16 else "resample_preframed"
    taps = np.asarray(taps, np.float32)
    t = taps.shape[0]
    hist, stride = resample_geometry(t, up, down, out_tile)
    span = stride + hist
    _frame_geometry(stride, span)
    dword = word_u32(dword)
    dev = resolve(device)
    taps_t = torch.as_tensor(taps, device=dev)
    taps_ph = torch.as_tensor(phase_taps(taps, up), device=dev)

    def fn(word0, xr_f, xi_f):
        nt = check_frames(xr_f, xi_f, (), span, b_rows, in_dtype)
        if xr_f.device != dev:
            raise ValueError(f"frames on {xr_f.device}, kernel built for {dev}")
        if not cuda_or_cpu(xr_f):
            return resample_preframed_plain(word0, dword, xr_f, xi_f, taps_t, up, down,
                                            out_tile, hist)
        lib = _build.load()
        yr = torch.empty((nt, out_tile), dtype=torch.float32, device=xr_f.device)
        yi = torch.empty_like(yr)
        rc = lib.srcdsp_resample_preframed(xr_f.data_ptr(), xi_f.data_ptr(), taps_ph.data_ptr(),
                                           yr.data_ptr(), yi.data_ptr(), word_u32(word0),
                                           dword, nt, span, out_tile, up, down,
                                           taps_ph.shape[1], hist, int(bf16),
                                           _build.stream_handle(xr_f))
        _build.check(rc, counter)
        _build.LAUNCHES[counter] += 1
        return yr, yi

    return fn, hist, stride, span
