"""Fully fused FSK front end, kernel K2 (counterpart of
``srcdsp_tpu/kernels/fsk_fused.py``).

One launch per block does the whole per-sample work of the config-4 chain:
NCO mix -> FIR + decimate -> frequency discriminator -> O&M timing partial
sums. Only the per-block scalar math (tau from the summed accumulator, the
symbol pick) remains outside, in `demod_tail`.

Outputs, as the JAX kernel's: d [C, NT, OT] (cycles/sample) and
st [C, NT, 128] (col 0 = the row's sum(d^2 * cos tone), col 1 = the -sin
counterpart, the rest zeros). Each call starts from rest: output 0 of each
channel has d = 0 (the one-sample seam per call). class_major=True permutes
each row's lanes to offset-class-major order, lane o*(OT/sps)+s = sample
s*sps+o, so the symbol pick reads contiguous lanes.

The CUDA kernel is ``csrc/fsk.cu`` (``srcdsp_fsk_fused``); `fsk_fused_plain`
is the plain PyTorch version the wrapper runs for CPU tensors. The body runs
the register ring of ``csrc/fir_ring.cuh`` (K1's, real taps here; K3 and K7
run it with complex taps): a block owns whole rows of one channel, each
thread R consecutive outputs, and the discriminator takes y[J-1] from the
previous register, the previous thread's last output, or, for a tile's first
output, the same chain computed once more. The ownership, the predecessor,
the store index and the order of the O&M sums are mirrored here (`fsk_*`,
each citing its line) and checked in numpy by
``tests/test_torch_fsk_kernels.py``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.mixfir import (
    LANE, FirShape, _round_up, check_planes, cuda_or_cpu, fir_geometry, fir_shape, mix_fir_plain,
    ring_shape)
from srcdsp_tpu_torch.ops.nco import TWO_PI, word_tensor
from srcdsp_tpu_torch.types import F32

PAD = 128  # extra output columns (2 used for partial sums)


def _words_i32(words, c: int, device) -> torch.Tensor:
    """u32 words as an int32 tensor [C] with the same bits, for the kernel."""
    w = word_tensor(words).reshape(-1).expand(c)
    return (w - ((w >> 31) << 32)).to(torch.int32).to(device).contiguous()


def discriminate_call(yr: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """d [C, K] of one call's filtered planes [C, K]: atan2 of
    y[J]*conj(y[J-1]) / 2pi, with output 0 at rest (d = 0, the per-call seam)."""
    pr = torch.nn.functional.pad(yr[:, :-1], (1, 0))
    pi = torch.nn.functional.pad(yi[:, :-1], (1, 0))
    zr = yr * pr + yi * pi
    zi = yi * pr - yr * pi
    d = torch.atan2(zi, zr) * np.float32(1.0 / TWO_PI)
    d[:, 0] = 0.0
    return d


def om_partials(d: torch.Tensor, sps: int, out_tile: int) -> torch.Tensor:
    """st [C, NT, PAD] from d [C, K]: per-row O&M sums against the tone of
    the call-local output index mod sps."""
    c, k = d.shape
    g = torch.arange(k, dtype=torch.int64, device=d.device) % sps
    ang = g.to(F32) * np.float32(TWO_PI / sps)
    met = (d * d).reshape(c, -1, out_tile)
    st = torch.zeros((c, met.shape[1], PAD), dtype=F32, device=d.device)
    st[:, :, 0] = torch.sum(met * torch.cos(ang).reshape(-1, out_tile), dim=-1)
    st[:, :, 1] = torch.sum(met * (-torch.sin(ang)).reshape(-1, out_tile), dim=-1)
    return st


def to_class_major(d: torch.Tensor, sps: int) -> torch.Tensor:
    """[C, NT, OT] rows -> lanes permuted to (i % sps)*(OT/sps) + i//sps."""
    c, nt, ot = d.shape
    return d.reshape(c, nt, ot // sps, sps).transpose(-1, -2).reshape(c, nt, ot)


# The FSK body's ownership, predecessor, stores and O&M sums (csrc/fsk.cu on
# csrc/fir_ring.cuh), mirrored item by item; the ring's index map is
# kernels/mixfir's fir_* with shape=fsk_shape(decim, ctaps).
def fsk_shape(decim: int, ctaps: bool) -> FirShape:
    """fsk.cu:66-69 FskShape: the complex ring at R = 4 in blocks of 256 threads
    (K3, K7); K2 runs K1's ring and shape."""
    return ring_shape(decim, 4, 256) if ctaps else fir_shape(decim)


def fsk_rows(decim: int, out_tile: int, ctaps: bool) -> int:
    """fsk.cu:78-81: whole rows of OT a block owns, max(1, outputs // OT)."""
    outputs = fsk_shape(decim, ctaps).outputs
    return outputs // out_tile if out_tile < outputs else 1


def fsk_geometry(decim: int, num_taps: int, hist: int, ctaps: bool
                 ) -> tuple[int, int, int, int]:
    """fsk.cu:231: the ring's geometry with room for output J-1 of the first
    (pre = decim): (tp, lead, span, plane)."""
    return fir_geometry(decim, num_taps, hist, fsk_shape(decim, ctaps), pre=decim)


def fsk_blocks(nt: int, decim: int, out_tile: int, ctaps: bool) -> int:
    """fsk.cu:235-236: blocks of a launch along the rows (one grid row a channel)."""
    return -(-nt // fsk_rows(decim, out_tile, ctaps))


def fsk_tiles(block: int, nt: int, decim: int, out_tile: int, ctaps: bool) -> list[int]:
    """fsk.cu:129-132: the block-local first output t0 of each tile; the
    block owns rows [r0, r0 + rows) and bo = rows*OT outputs."""
    rows_b = fsk_rows(decim, out_tile, ctaps)
    rows = min(rows_b, nt - block * rows_b)
    return list(range(0, rows * out_tile, fsk_shape(decim, ctaps).outputs))


def fsk_output(block: int, t0: int, tid, k: int, nt: int, decim: int, out_tile: int,
               ctaps: bool):
    """fsk.cu:133, :160 and :180: (channel-local J of output k of thread `tid`
    in the tile at t0, whether it is stored: block-local index < bo)."""
    sh = fsk_shape(decim, ctaps)
    rows_b = fsk_rows(decim, out_tile, ctaps)
    r0 = block * rows_b
    local = t0 + np.asarray(tid) * sh.r + k
    return r0 * out_tile + local, local < min(rows_b, nt - r0) * out_tile


def fsk_window_start(block: int, t0: int, decim: int, num_taps: int, hist: int,
                     out_tile: int, ctaps: bool) -> int:
    """fsk.cu:140: stream sample of window index 0 of the tile at t0."""
    lead = fsk_geometry(decim, num_taps, hist, ctaps)[1]
    return (block * fsk_rows(decim, out_tile, ctaps) * out_tile + t0) * decim - lead


def fsk_predecessor(tid, lead: int, hist: int, decim: int, ctaps: bool):
    """fsk.cu:144-153 and :163: where output 0 of thread `tid` finds y[J-1]:
    ("slot", tid - 1), the previous thread's last output, or for thread 0
    ("chain", e), the chain over taps 0..T-1 at window index e - a."""
    tid = np.asarray(tid)
    return np.where(tid > 0, tid - 1, hist + lead - decim), tid > 0


def fsk_store_index(local, out_tile: int, sps: int, class_major: bool):
    """fsk.cu:161-162, :180 and :183-191: (block-local row, lane) of d for
    block-local output `local`; lane = (col % sps)*(OT/sps) + col//sps in
    class-major order, col otherwise."""
    local = np.asarray(local)
    row, col = local // out_tile, local % out_tile
    lane = (col % sps) * (out_tile // sps) + col // sps if class_major else col
    return row, lane


def fsk_row_terms(t0: int, tn: int, out_tile: int, warps: int) -> list[tuple]:
    """fsk.cu:195-212: (row, warp, lo, end) for each row that the tile
    [t0, t0 + tn) touches: warp `warp` sums its terms lo..end-1 (tile-local),
    lane l taking l, l + 32, ..., then a butterfly; tiles add in order."""
    return [(rr, (rr - t0 // out_tile) % warps, max(rr * out_tile - t0, 0),
             min((rr + 1) * out_tile - t0, tn))
            for rr in range(t0 // out_tile, (t0 + tn - 1) // out_tile + 1)]


def kernel_info(kernel: str, decim: int, num_taps: int, hist: int, out_tile: int, sps: int,
                bf16: bool = False) -> tuple[int, int, int]:
    """(registers, local-memory bytes, resident blocks per SM) of the K2
    ("fused"), K3 ("ctaps") or K7 ("preframed") instantiation that runs
    `decim` (on the card). Local bytes include the 32-byte stack frame of
    cosf/sinf/atan2f's slow path, not spills (ptxas reports those:
    _build.ptxas_report)."""
    out = [ctypes.c_int(0) for _ in range(3)]
    which = {"fused": 0, "ctaps": 1, "preframed": 2}[kernel]
    _build.check(_build.load().srcdsp_fsk_info(which, int(bf16), decim, num_taps, hist,
                                               out_tile, sps, *map(ctypes.byref, out)),
                 "fsk_info")
    return tuple(v.value for v in out)


def fsk_fused_plain(words0, dwords, x: torch.Tensor, taps: torch.Tensor, decim: int,
                    out_tile: int, hist: int, sps: int, class_major: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2: x [C, 2, HK+N] -> (d [C, NT, OT], st [C, NT, PAD])."""
    yr, yi = mix_fir_plain(words0, dwords, x, taps, decim, out_tile, hist)
    c = x.shape[0]
    d = discriminate_call(yr.reshape(c, -1), yi.reshape(c, -1))
    st = om_partials(d, sps, out_tile)
    d = d.reshape(c, -1, out_tile)
    return (to_class_major(d, sps) if class_major else d), st


def make_fsk_mc_kernel(taps, decim: int, num_channels: int, sps: int,
                       out_tile: int = 512, b_rows: int = 8,
                       class_major: bool = False, device=None):
    """Build K2. Returns (fn, hist) with
    fn: (words0 [C], dwords [C], x [C, 2, HK+N]) -> (d [C, NT, OT], st [C, NT, 128]).

    Words are u32 values, or int32 holding the same bits (the JAX fn's
    ``i32[C, 1]``). The TPU version's block_cols, precision, pipelined and
    interpret options shape only the Pallas lowering and have no counterpart.
    """
    taps = np.asarray(taps, np.float32)
    if out_tile % sps != 0:
        raise ValueError(f"out_tile {out_tile} % sps {sps} != 0")
    t = taps.shape[-1]
    hist = _round_up(t - 1, LANE)
    block = b_rows * out_tile * decim
    taps_t = torch.as_tensor(taps, device=resolve(device)).contiguous()

    def fn(words0, dwords, x):
        n = check_planes(x, num_channels, hist, block)
        if x.device != taps_t.device:
            raise ValueError(f"x on {x.device}, kernel built for {taps_t.device}")
        if not cuda_or_cpu(x):
            return fsk_fused_plain(words0, dwords, x, taps_t, decim, out_tile, hist, sps,
                                   class_major)
        lib = _build.load()
        nt = n // (out_tile * decim)
        w0 = _words_i32(words0, num_channels, x.device)
        dw = _words_i32(dwords, num_channels, x.device)
        d = torch.empty((num_channels, nt, out_tile), dtype=F32, device=x.device)
        st = torch.empty((num_channels, nt, PAD), dtype=F32, device=x.device)
        rc = lib.srcdsp_fsk_fused(x.data_ptr(), w0.data_ptr(), dw.data_ptr(),
                                  taps_t.data_ptr(), d.data_ptr(), st.data_ptr(),
                                  num_channels, x.shape[-1], nt, out_tile, decim, t, hist,
                                  sps, int(class_major), _build.stream_handle(x))
        _build.check(rc, "fsk_fused")
        _build.LAUNCHES["fsk_fused"] += 1
        return d, st

    return fn, hist


def fsk_demod_fused(fn, hist: int, out_tile: int, words0, dwords, x_planes, sps: int,
                    state=None, class_major: bool = False):
    """K2 + the tail (tau + symbol pick).

    x_planes: [C, 2, HK+N]; state: (acc_r [C,1], acc_i [C,1]) or None.
    Returns (state, (bits [C, Nsym] int32, soft [C, Nsym] f32)).
    """
    dd, st = fn(words0, dwords, x_planes)
    return demod_tail(dd, st, sps, out_tile, state, class_major)


def demod_tail(dd: torch.Tensor, st: torch.Tensor, sps: int, out_tile: int, state=None,
               class_major: bool = False):
    """The tail shared by the fused-kernel wrappers: O&M tau from the
    in-kernel partial sums, then the nearest-offset symbol pick."""
    from srcdsp_tpu_torch.chains.fsk_planes import pick_symbols

    cch = dd.shape[0]
    rs_c = torch.sum(st[:, :, 0], dim=-1, keepdim=True)
    rs_s = torch.sum(st[:, :, 1], dim=-1, keepdim=True)
    if state is None:
        z = torch.zeros((cch, 1), dtype=F32, device=dd.device)
        state = (z, z)
    acc_r = np.float32(0.5) * state[0] + rs_c
    acc_i = np.float32(0.5) * state[1] + rs_s
    tau = torch.remainder(np.float32(-sps / TWO_PI) * torch.atan2(acc_i, acc_r), sps)
    if class_major:
        # lane block o of every row holds that row's samples at offset o
        off = torch.remainder(torch.round(tau), sps).to(torch.int64)[:, 0]   # [C]
        spr = out_tile // sps
        blocks = dd.reshape(cch, dd.shape[1], sps, spr)
        soft = blocks[torch.arange(cch, device=dd.device), :, off].reshape(cch, -1)
    else:
        soft = pick_symbols(dd.reshape(cch, -1), tau, sps)
    bits = (soft > 0).to(torch.int32)
    return (acc_r, acc_i), (bits, soft)
