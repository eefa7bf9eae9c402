"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips when torch.cuda.is_available() is false. Run on
a machine with the card: python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels import fsk_ctaps as kct
from srcdsp_tpu_torch.kernels import fsk_fused as kff
from srcdsp_tpu_torch.kernels import mixfir as kmf
from srcdsp_tpu_torch.ops.nco import freq_to_word
from srcdsp_tpu_torch.ops.window import lowpass
from srcdsp_tpu_torch.testing.signals import fsk_baseband, random_bits, tone

pytestmark = pytest.mark.cuda
C, DECIM, SPS, OT = 3, 4, 8, 512


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fsk_planes(dev, nsym=2048):
    centers = [0.11 + 0.01 * c for c in range(C)]
    bits = random_bits(np.random.default_rng(0), (C, nsym))
    bb = fsk_baseband(bits, DECIM * SPS, 0.05 / DECIM)
    x = np.stack([bb[c] * tone(bb.shape[-1], centers[c]) for c in range(C)])
    x = np.concatenate([np.zeros((C, 128), np.complex64), x], axis=1)
    words = np.asarray([freq_to_word(-c) for c in centers], np.uint32)
    planes = torch.as_tensor(np.stack([x.real, x.imag], 1).astype(np.float32), device=dev)
    return planes, words


@pytest.mark.parametrize("per_channel", [False, True])
def test_mixfir_kernel_matches_plain(dev, per_channel):
    planes, words = _fsk_planes(dev)
    taps = lowpass(64, 0.03)
    if per_channel:
        taps = np.stack([lowpass(64, 0.03 + 0.005 * c) for c in range(C)])
    k = kmf.make_mix_fir_kernel_mc(taps, DECIM, C, out_tile=OT, b_rows=8, device=dev)
    words0 = [(-k.hist * int(w)) % (1 << 32) for w in words]
    before = _build.LAUNCHES["mixfir_mc"]
    yr, yi = k.fn(words0, words, planes)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mixfir_mc"] == before + 1
    pr, pi = kmf.mix_fir_plain(words0, words, planes, torch.as_tensor(taps, device=dev),
                               DECIM, OT, k.hist)
    got = torch.complex(yr, yi)
    ref = torch.complex(pr, pi)
    assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) < 1e-5


@pytest.mark.parametrize("class_major", [False, True])
@pytest.mark.parametrize("ctaps", [False, True])
def test_fsk_kernels_match_plain(dev, ctaps, class_major):
    planes, words = _fsk_planes(dev)
    taps = lowpass(64, 0.03)
    if ctaps:
        fn, hist = kct.make_fsk_ctaps_kernel(taps, words, DECIM, SPS, out_tile=OT,
                                             b_rows=8, class_major=class_major, device=dev)
        d, st = fn(planes)
        gr, gi, deltas = (torch.as_tensor(a, device=dev)
                          for a in kct.ctaps_host(taps, words, DECIM))
        pd, pst = kct.fsk_ctaps_plain(planes, gr, gi, deltas, DECIM, OT, hist, SPS,
                                      class_major)
    else:
        fn, hist = kff.make_fsk_mc_kernel(taps, DECIM, C, SPS, out_tile=OT, b_rows=8,
                                          class_major=class_major, device=dev)
        words0 = [(-hist * int(w)) % (1 << 32) for w in words]
        d, st = fn(words0, words, planes)
        pd, pst = kff.fsk_fused_plain(words0, words, planes,
                                      torch.as_tensor(taps, device=dev), DECIM, OT, hist,
                                      SPS, class_major)
    torch.cuda.synchronize()
    assert float((d - pd).abs().max()) < 1e-4
    torch.testing.assert_close(st, pst, rtol=1e-4, atol=1e-3)
    _, (bits, _) = kff.demod_tail(d, st, SPS, OT, class_major=class_major)
    _, (pbits, _) = kff.demod_tail(pd, pst, SPS, OT, class_major=class_major)
    assert torch.equal(bits, pbits)


def test_cuda_tensor_with_cpu_kernel_raises(dev):
    k = kmf.make_mix_fir_kernel_mc(lowpass(64, 0.03), DECIM, C, out_tile=OT, b_rows=8)
    x = torch.zeros((C, 2, k.hist + k.block_in()), device=dev)
    with pytest.raises(ValueError, match="kernel built for cpu"):
        k.fn([0] * C, [1] * C, x)
