"""FSK demod in plane form (counterpart of ``srcdsp_tpu/chains/fsk_planes.py``).

    planes -> [K1 fused mix+FIR+decim] -> discriminator -> O&M timing
           -> nearest-offset symbol pick -> bits

Differences vs chains.fsk, as in the JAX package: the symbol pick is the
nearest integer offset (no interpolation), and the timing tone weights are
host-precomputed constants.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.kernels.mixfir import MixFirKernel, mix_fir_decim_mc
from srcdsp_tpu_torch.ops.nco import TWO_PI
from srcdsp_tpu_torch.types import F32


def discriminate_planes(yr: torch.Tensor, yi: torch.Tensor,
                        pr: torch.Tensor, pi: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Instantaneous frequency from baseband planes.

    yr/yi: [C, K]; pr/pi: [C, 1] previous block's last sample (zeros at
    start). Returns (d [C, K] cycles/sample, new pr, new pi).
    """
    sr = torch.cat([pr, yr[:, :-1]], dim=1)
    si = torch.cat([pi, yi[:, :-1]], dim=1)
    zr = yr * sr + yi * si          # y[n] * conj(y[n-1])
    zi = yi * sr - yr * si
    d = torch.atan2(zi, zr) * np.float32(1.0 / TWO_PI)
    return d, yr[:, -1:], yi[:, -1:]


def make_timing_tone(k: int, sps: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side O&M tone weights cos/sin(-2*pi*n/sps), shape [1, K]."""
    n = np.arange(k)
    ang = -2.0 * np.pi * (n % sps) / sps
    return (np.cos(ang)[None].astype(np.float32),
            np.sin(ang)[None].astype(np.float32))


def om_timing_planes(metric: torch.Tensor, tone_cos: torch.Tensor,
                     tone_sin: torch.Tensor, acc_r: torch.Tensor, acc_i: torch.Tensor,
                     sps: int, forget: float = 0.5
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O&M estimate on planes. metric [C, K] -> (tau [C,1], acc_r, acc_i)."""
    cr = torch.sum(metric * tone_cos, dim=-1, keepdim=True)
    ci = torch.sum(metric * tone_sin, dim=-1, keepdim=True)
    acc_r = np.float32(forget) * acc_r + cr
    acc_i = np.float32(forget) * acc_i + ci
    tau = torch.remainder(np.float32(-sps / TWO_PI) * torch.atan2(acc_i, acc_r), sps)
    return tau, acc_r, acc_i


def pick_symbols(d: torch.Tensor, tau: torch.Tensor, sps: int) -> torch.Tensor:
    """Nearest-offset symbol pick. d: [C, K], K % sps == 0; tau: [C, 1] in
    [0, sps). Returns soft symbols [C, K/sps] (the one-hot reduce of the JAX
    package, as an index select)."""
    c, k = d.shape
    off = torch.remainder(torch.round(tau), sps).to(torch.int64)     # [C, 1]
    d3 = d.reshape(c, k // sps, sps)
    return torch.gather(d3, 2, off[:, :, None].expand(c, k // sps, 1))[..., 0]


def fsk_demod_planes(kernel: MixFirKernel, words0, dwords, x_planes: torch.Tensor,
                     sps: int, tone_cos: torch.Tensor, tone_sin: torch.Tensor,
                     state=None):
    """Full plane-form FSK demod. x_planes: [C, 2, HK+N] -> bits [C, Nsym].

    state: (pr, pi, acc_r, acc_i) or None for stream start. Returns
    (new_state, (bits int32 [C, Nsym], soft f32 [C, Nsym])).
    """
    cch = x_planes.shape[0]
    if state is None:
        z = torch.zeros((cch, 1), dtype=F32, device=x_planes.device)
        state = (z, z, z, z)
    pr, pi, acc_r, acc_i = state
    yr, yi = mix_fir_decim_mc(kernel, words0, dwords, x_planes)
    d, pr, pi = discriminate_planes(yr, yi, pr, pi)
    tau, acc_r, acc_i = om_timing_planes(d * d, tone_cos, tone_sin, acc_r, acc_i, sps)
    soft = pick_symbols(d, tau, sps)
    bits = (soft > 0).to(torch.int32)
    return (pr, pi, acc_r, acc_i), (bits, soft)


class FskPlanesStream:
    """Stream class for the plane-form chain: keeps the kernel history
    prefix, per-chunk NCO start words and the demod accumulators, so callers
    feed raw [C, 2, N] plane chunks (N a multiple of kernel.block_in()) and
    receive bits. Chunked output is bit-identical to one-shot."""

    def __init__(self, kernel: MixFirKernel, dwords, sps: int, tone_cos, tone_sin,
                 num_channels: int):
        self.kernel = kernel
        self.dwords = [int(d) for d in np.asarray(dwords, np.uint64).reshape(-1)]
        self.sps = sps
        self.tone_cos = torch.as_tensor(tone_cos, device=kernel.device)
        self.tone_sin = torch.as_tensor(tone_sin, device=kernel.device)
        # phase word of the NEXT history prefix's first sample; start so the
        # first real sample carries phase 0 (one-shot convention)
        self.words0 = [(-kernel.hist * d) % (1 << 32) for d in self.dwords]
        self.hist = torch.zeros((num_channels, 2, kernel.hist), dtype=F32,
                                device=kernel.device)
        self.state = None

    def process(self, x_chunk: torch.Tensor):
        """x_chunk: [C, 2, N] raw planes -> (bits, soft) for this chunk."""
        xin = torch.cat([self.hist, x_chunk], dim=-1)
        self.state, out = fsk_demod_planes(
            self.kernel, np.asarray(self.words0, np.uint32),
            np.asarray(self.dwords, np.uint32), xin, self.sps, self.tone_cos,
            self.tone_sin, state=self.state)
        n = x_chunk.shape[-1]
        self.words0 = [(w + n * d) % (1 << 32) for w, d in zip(self.words0, self.dwords)]
        self.hist = xin[..., xin.shape[-1] - self.kernel.hist:].contiguous()
        return out
