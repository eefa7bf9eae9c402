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
from srcdsp_tpu_torch.kernels import fsk_preframed as kfp
from srcdsp_tpu_torch.kernels import mixfir as kmf
from srcdsp_tpu_torch.kernels import mixfir_ctaps as kmc
from srcdsp_tpu_torch.kernels import mixfir_preframed as kpf
from srcdsp_tpu_torch.ops.nco import freq_to_word
from srcdsp_tpu_torch.ops.window import lowpass
from srcdsp_tpu_torch.testing.signals import fsk_baseband, random_bits, tone

pytestmark = pytest.mark.cuda
C, DECIM, SPS, OT = 3, 4, 8, 512
BF16 = torch.bfloat16


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


def _rel(k, p):
    got, ref = torch.complex(*k), torch.complex(*p)
    return float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_ctaps_kernels_match_plain_and_each_other(dev, dtype):
    """K4 and K5 against their plain versions (rel L2 < 1e-5 on the same
    input), K5 == K4 bit for bit, and K6 frames == frame_planes."""
    taps, word = lowpass(64, 0.2), int(freq_to_word(0.11))
    k4 = kmc.make_mix_fir_ctaps_kernel(taps, word, 2, out_tile=OT, b_rows=8, in_dtype=dtype,
                                       device=dev)
    fn5, hist, stride, span = kpf.make_ctaps_preframed_kernel(
        taps, word, 2, out_tile=OT, b_rows=8, in_dtype=dtype, device=dev)
    n = 4 * k4.block_in()
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((2, hist + n)),
                        dtype=torch.float32, device=dev).to(dtype)
    w0 = (-hist * word) % (1 << 32)
    before = dict(_build.LAUNCHES)
    y4 = k4.fn(w0, x)
    xr_f, xi_f = kpf.make_frame_kernel(stride, span, b_rows=8, in_dtype=dtype, device=dev)(x)
    y5 = fn5(w0, xr_f, xi_f)
    torch.cuda.synchronize()
    sfx = "_bf16" if dtype == BF16 else ""
    for name in ("mixfir_ctaps" + sfx, "ctaps_preframed" + sfx, "frame"):
        assert _build.LAUNCHES[name] == before[name] + 1
    ref = kpf.frame_planes(x, stride, span)
    assert torch.equal(xr_f, ref[0]) and torch.equal(xi_f, ref[1])
    gr, gi = (torch.as_tensor(a[0], device=dev) for a in kct.ctaps_host(taps, [word], 2)[:2])
    assert _rel(y4, kmc.mix_fir_ctaps_plain(w0, word, x, gr, gi, 2, OT, hist)) < 1e-5
    assert torch.equal(y5[0], y4[0]) and torch.equal(y5[1], y4[1])


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_fsk_preframed_matches_plain_and_ctaps(dev, dtype):
    """K7 and K3 (both dtypes) against their plain versions, K7 == K3 bit for bit."""
    planes, words = _fsk_planes(dev)
    planes = planes.to(dtype)
    taps = lowpass(64, 0.03)
    fn3, hist = kct.make_fsk_ctaps_kernel(taps, words, DECIM, SPS, out_tile=OT, b_rows=8,
                                          class_major=True, in_dtype=dtype, device=dev)
    fn7, _, stride, span = kfp.make_fsk_preframed_kernel(
        taps, words, DECIM, SPS, out_tile=OT, b_rows=8, class_major=True, in_dtype=dtype,
        device=dev)
    fr = kpf.frame_planes(planes, stride, span)
    xr_f, xi_f = fr[:, 0].contiguous(), fr[:, 1].contiguous()
    d3, st3 = fn3(planes)
    d7, st7 = fn7(xr_f, xi_f)
    gr, gi, deltas = (torch.as_tensor(a, device=dev)
                      for a in kct.ctaps_host(taps, words, DECIM))
    pd, pst = kct.fsk_ctaps_plain(planes, gr, gi, deltas, DECIM, OT, hist, SPS, True)
    torch.cuda.synchronize()
    assert torch.equal(d7, d3) and torch.equal(st7, st3)
    assert float((d3 - pd).abs().max()) < 1e-4
    torch.testing.assert_close(st3, pst, rtol=1e-4, atol=1e-3)
    _, (bits, _) = kff.demod_tail(d3, st3, SPS, OT, class_major=True)
    _, (pbits, _) = kff.demod_tail(pd, pst, SPS, OT, class_major=True)
    assert torch.equal(bits, pbits)


def test_cuda_wrong_dtype_raises_before_launch(dev):
    k = kmc.make_mix_fir_ctaps_kernel(lowpass(64, 0.2), 1 << 28, 2, out_tile=OT, b_rows=8,
                                      device=dev)
    x = torch.zeros((2, k.hist + k.block_in()), dtype=BF16, device=dev)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="in_dtype"):
        k.fn(0, x)
    assert _build.LAUNCHES == before
