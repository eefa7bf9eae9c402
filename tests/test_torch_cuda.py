"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips when torch.cuda.is_available() is false. Run on
a machine with the card: python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import re

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
from srcdsp_tpu_torch.kernels import resample_pallas as krs
from srcdsp_tpu_torch.kernels import resample_preframed as krp
from srcdsp_tpu_torch.ops.nco import freq_to_word
from srcdsp_tpu_torch.ops.window import lowpass, root_raised_cosine
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


@pytest.mark.parametrize("ot", [128, 512])
@pytest.mark.parametrize("t", [32, 64, 128])
@pytest.mark.parametrize("decim", [1, 2, 4])
@pytest.mark.parametrize("per_channel", [False, True])
def test_mixfir_kernel_matches_plain(dev, per_channel, decim, t, ot):
    """K1 mc (each decim's own instantiation) against its plain version: rel
    L2 < 1e-5; the words by value, one launch."""
    planes, words = _fsk_planes(dev)
    taps = lowpass(t, 0.4 / decim)
    if per_channel:
        taps = np.stack([lowpass(t, 0.3 / decim + 0.005 * c) for c in range(C)])
    k = kmf.make_mix_fir_kernel_mc(taps, decim, C, out_tile=ot, b_rows=8, device=dev)
    words0 = [(-k.hist * int(w)) % (1 << 32) for w in words]
    before = _build.LAUNCHES["mixfir_mc"]
    yr, yi = k.fn(words0, words, planes)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mixfir_mc"] == before + 1
    pr, pi = kmf.mix_fir_plain(words0, words, planes, torch.as_tensor(taps, device=dev),
                               decim, ot, k.hist)
    got = torch.complex(yr, yi)
    ref = torch.complex(pr, pi)
    assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) < 1e-5


@pytest.mark.parametrize("decim,ot", [(3, 128), (8, 128), (2, 90)])
def test_mixfir_kernel_generic_and_partial_blocks(dev, decim, ot):
    """Another decim runs the generic instantiation (R = 1); an output count
    that leaves the last block part full stores only its outputs; 40
    channels take two launch groups of by-value words."""
    c = 40
    taps = lowpass(48, 0.4 / decim)
    k = kmf.make_mix_fir_kernel_mc(taps, decim, c, out_tile=ot, b_rows=3, device=dev)
    x = torch.as_tensor(np.random.default_rng(decim).standard_normal(
        (c, 2, k.hist + 5 * k.block_in())).astype(np.float32), device=dev)
    words = np.asarray([freq_to_word(-0.1 - 0.003 * i) for i in range(c)], np.uint32)
    words0 = [(-k.hist * int(w)) % (1 << 32) for w in words]
    yr, yi = k.fn(words0, words, x)
    pr, pi = kmf.mix_fir_plain(words0, words, x, torch.as_tensor(taps, device=dev), decim, ot,
                               k.hist)
    assert _rel((yr, yi), (pr, pi)) < 1e-5
    regs, spill, blocks = kmf.kernel_info(decim, 48, k.hist)
    assert spill == 0 and blocks >= 1 and regs > 0


@pytest.mark.parametrize("decim", [1, 2, 4])
def test_mixfir_kernel_no_spills_four_blocks_per_sm(dev, decim):
    for halo in (False, True):
        regs, spill, blocks = kmf.kernel_info(decim, 64, 128, halo=halo)
        assert spill == 0 and regs <= 64 and blocks >= 4, (halo, regs, spill, blocks)


def test_mixfir_kernel_matches_plain_modem_front_end(dev):
    """K1 mc as the coded modem runs it: 33 RRC taps (odd), decim 2."""
    planes, words = _fsk_planes(dev)
    taps = root_raised_cosine(2, 16, beta=0.35)
    k = kmf.make_mix_fir_kernel_mc(taps, 2, C, out_tile=OT, b_rows=8, device=dev)
    assert k.num_taps == 33
    words0 = [(-k.hist * int(w)) % (1 << 32) for w in words]
    yr, yi = k.fn(words0, words, planes)
    pr, pi = kmf.mix_fir_plain(words0, words, planes, torch.as_tensor(taps, device=dev), 2, OT,
                               k.hist)
    got, ref = torch.complex(yr, yi), torch.complex(pr, pi)
    assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) < 1e-5


def _fsk_case(dev, ctaps, class_major, decim, t, ot, b_rows, planes, words):
    """One FSK launch (K3 when ctaps, else K2) and its plain version."""
    taps = lowpass(t, 0.03 * 4 / decim)
    if ctaps:
        fn, hist = kct.make_fsk_ctaps_kernel(taps, words, decim, SPS, out_tile=ot,
                                             b_rows=b_rows, class_major=class_major, device=dev)
        d, st = fn(planes)
        gr, gi, deltas = (torch.as_tensor(a, device=dev)
                          for a in kct.ctaps_host(taps, words, decim))
        pd, pst = kct.fsk_ctaps_plain(planes, gr, gi, deltas, decim, ot, hist, SPS,
                                      class_major)
    else:
        fn, hist = kff.make_fsk_mc_kernel(taps, decim, C, SPS, out_tile=ot, b_rows=b_rows,
                                          class_major=class_major, device=dev)
        words0 = [(-hist * int(w)) % (1 << 32) for w in words]
        d, st = fn(words0, words, planes)
        pd, pst = kff.fsk_fused_plain(words0, words, planes,
                                      torch.as_tensor(taps, device=dev), decim, ot, hist,
                                      SPS, class_major)
    torch.cuda.synchronize()
    return d, st, pd, pst


def _fsk_agree(d, st, pd, pst, ot, class_major):
    assert float((d - pd).abs().max()) < 1e-4
    torch.testing.assert_close(st, pst, rtol=1e-4, atol=1e-3)
    _, (bits, _) = kff.demod_tail(d, st, SPS, ot, class_major=class_major)
    _, (pbits, _) = kff.demod_tail(pd, pst, SPS, ot, class_major=class_major)
    assert torch.equal(bits, pbits)


@pytest.mark.parametrize("t", [33, 64])
@pytest.mark.parametrize("decim", [2, 4])
@pytest.mark.parametrize("class_major", [False, True])
@pytest.mark.parametrize("ctaps", [False, True])
def test_fsk_kernels_match_plain(dev, ctaps, class_major, decim, t):
    """K2 and K3 (each decim's ring) against their plain versions: d within
    1e-4, st within rtol 1e-4 / atol 1e-3, decisions equal."""
    planes, words = _fsk_planes(dev)
    d, st, pd, pst = _fsk_case(dev, ctaps, class_major, decim, t, OT, 8, planes, words)
    _fsk_agree(d, st, pd, pst, OT, class_major)


@pytest.mark.parametrize("ot,b_rows,blocks", [(384, 3, 13), (2048, 1, 4)])
@pytest.mark.parametrize("ctaps", [False, True])
def test_fsk_kernels_partial_and_tiled_blocks(dev, ctaps, ot, b_rows, blocks):
    """A last block with fewer rows than the others (OT 384: two rows a
    block, an odd row count) and rows longer than a block's tile (OT 2048:
    tiles of one row in turn), against the plain versions."""
    planes, words = _fsk_planes(dev)
    n = blocks * b_rows * ot * DECIM
    planes = planes[..., :128 + n].contiguous()
    d, st, pd, pst = _fsk_case(dev, ctaps, True, DECIM, 64, ot, b_rows, planes, words)
    assert d.shape[1] % 2 == 1 or ot == 2048
    _fsk_agree(d, st, pd, pst, ot, True)


def test_cuda_tensor_with_cpu_kernel_raises(dev):
    k = kmf.make_mix_fir_kernel_mc(lowpass(64, 0.03), DECIM, C, out_tile=OT, b_rows=8, device="cpu")
    x = torch.zeros((C, 2, k.hist + k.block_in()), device=dev)
    with pytest.raises(ValueError, match="kernel built for cpu"):
        k.fn([0] * C, [1] * C, x)


def _rel(k, p):
    got, ref = torch.complex(*k), torch.complex(*p)
    return float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))


@pytest.mark.parametrize("decim,t,ot", [(2, 64, OT), (2, 33, OT), (4, 64, OT), (4, 33, OT),
                                         (2, 64, 384)])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_ctaps_kernels_match_plain_and_each_other(dev, dtype, decim, t, ot):
    """K4 and K5 against their plain versions (rel L2 < 1e-5 on the same
    input), K5 == K4 bit for bit, and K6 frames == frame_planes; OT 384 with
    b_rows 3 leaves the last block of 1024 outputs part full."""
    taps, word = lowpass(t, 0.4 / decim), int(freq_to_word(0.11))
    b_rows = 8 if ot == OT else 3
    k4 = kmc.make_mix_fir_ctaps_kernel(taps, word, decim, out_tile=ot, b_rows=b_rows,
                                       in_dtype=dtype, device=dev)
    fn5, hist, stride, span = kpf.make_ctaps_preframed_kernel(
        taps, word, decim, out_tile=ot, b_rows=b_rows, in_dtype=dtype, device=dev)
    n = 4 * k4.block_in()
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((2, hist + n)),
                        dtype=torch.float32, device=dev).to(dtype)
    w0 = (-hist * word) % (1 << 32)
    before = dict(_build.LAUNCHES)
    y4 = k4.fn(w0, x)
    xr_f, xi_f = kpf.make_frame_kernel(stride, span, b_rows=b_rows, in_dtype=dtype,
                                       device=dev)(x)
    y5 = fn5(w0, xr_f, xi_f)
    torch.cuda.synchronize()
    sfx = "_bf16" if dtype == BF16 else ""
    for name in ("mixfir_ctaps" + sfx, "ctaps_preframed" + sfx, "frame"):
        assert _build.LAUNCHES[name] == before[name] + 1
    ref = kpf.frame_planes(x, stride, span)
    assert torch.equal(xr_f, ref[0]) and torch.equal(xi_f, ref[1])
    gr, gi = (torch.as_tensor(a[0], device=dev)
              for a in kct.ctaps_host(taps, [word], decim)[:2])
    assert _rel(y4, kmc.mix_fir_ctaps_plain(w0, word, x, gr, gi, decim, ot, hist)) < 1e-5
    assert torch.equal(y5[0], y4[0]) and torch.equal(y5[1], y4[1])


@pytest.mark.parametrize("decim", [2, 4])
def test_preframed_kernels_read_each_sample_from_its_own_row(dev, decim):
    """K5 and K7 over frames whose overlaps disagree (independent random
    rows, not cut from one stream): a block spans several rows and reads each
    sample from the row deframe takes it from, so K5 == K4 and K7 == K3 on
    the deframed stream, bit for bit."""
    rng = np.random.default_rng(decim)
    taps, word = lowpass(64, 0.4 / decim), int(freq_to_word(0.11))
    fn5, hist, stride, span = kpf.make_ctaps_preframed_kernel(
        taps, word, decim, out_tile=OT, b_rows=8, device=dev)
    k4 = kmc.make_mix_fir_ctaps_kernel(taps, word, decim, out_tile=OT, b_rows=8, device=dev)
    fr = torch.as_tensor(rng.standard_normal((2, 16, span)).astype(np.float32), device=dev)
    w0 = (-hist * word) % (1 << 32)
    y5 = fn5(w0, fr[0], fr[1])
    y4 = k4.fn(w0, torch.stack([kpf.deframe(fr[0], stride), kpf.deframe(fr[1], stride)]))
    assert torch.equal(y5[0], y4[0]) and torch.equal(y5[1], y4[1])
    _, words = _fsk_planes(dev)
    fn7, _, stride7, span7 = kfp.make_fsk_preframed_kernel(
        taps, words, decim, SPS, out_tile=OT, b_rows=8, class_major=True, device=dev)
    fn3, _ = kct.make_fsk_ctaps_kernel(taps, words, decim, SPS, out_tile=OT, b_rows=8,
                                       class_major=True, device=dev)
    fr7 = torch.as_tensor(rng.standard_normal((C, 2, 16, span7)).astype(np.float32), device=dev)
    xr_f, xi_f = fr7[:, 0].contiguous(), fr7[:, 1].contiguous()
    d7, st7 = fn7(xr_f, xi_f)
    d3, st3 = fn3(torch.stack([kpf.deframe(xr_f, stride7), kpf.deframe(xi_f, stride7)], 1))
    assert torch.equal(d7, d3) and torch.equal(st7, st3)


def _spills(pattern: str) -> dict:
    """ptxas's (registers, spill stores, spill loads) of the built kernels
    whose mangled name matches `pattern`."""
    return {k: v for k, v in _build.ptxas_report().items() if re.search(pattern, k)}


@pytest.mark.parametrize("decim", [1, 2, 4, 3])
def test_ctaps_and_fsk_kernels_no_spills_four_blocks_per_sm(dev, decim):
    """ptxas reports no spill in any complex-taps or FSK instantiation, and
    each one that runs `decim` keeps at least 4 blocks an SM at T 64."""
    _build.load()
    found = _spills(r"(ctaps|fsk)_kernel")
    assert len(found) == 20 + 20 + 8 + 8  # and the bf16 sources read in pairs
    assert not {k: v for k, v in found.items() if v[1] or v[2]}
    for source, bf16 in (("planes", False), ("planes", True), ("frames", False),
                         ("frames", True), ("split", False)):
        regs, _, blocks = kmc.kernel_info(source, decim, 64, 128, bf16)
        assert regs <= 64 and blocks >= 4, (source, bf16, regs, blocks)
    for kernel, bf16 in (("fused", False), ("ctaps", False), ("ctaps", True),
                         ("preframed", False), ("preframed", True)):
        regs, _, blocks = kff.kernel_info(kernel, decim, 64, 128, OT, SPS, bf16)
        assert blocks >= 4, (kernel, bf16, regs, blocks)


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


def _c2_planes(dev, c, hist, n, seed=0):
    x = np.random.default_rng(seed).standard_normal((c, 2, hist + n)).astype(np.float32)
    x[..., :hist] = 0.0
    return torch.as_tensor(x, device=dev)


@pytest.mark.parametrize("channels", [1, 4, 37])
def test_mix_resample_matches_plain(dev, channels):
    """K8 at the config-2 combined taps (429 taps, 3/4, out_tile 384) against
    its plain version, rel L2 < 1e-5; each channel of the multichannel form
    equal to the single-channel kernel bit for bit (37 channels cross the
    by-value words' launch groups); chunked launches equal one launch."""
    hc = krs.combine_fir_resample_taps(lowpass(128, 0.2), lowpass(48, 0.3), 3)
    k1 = krs.make_mix_resample_kernel(hc, 3, 4, out_tile=384, b_rows=24, device=dev)
    kc = krs.make_mix_resample_kernel_mc(hc, 3, 4, channels, out_tile=384, b_rows=24,
                                         device=dev)
    n = 4 * kc.block_in()
    x = _c2_planes(dev, channels, kc.hist, n)
    words = [(int(freq_to_word(0.07)) + 7919 * c) % (1 << 32) for c in range(channels)]
    words0 = [(-kc.hist * w) % (1 << 32) for w in words]
    before = dict(_build.LAUNCHES)
    yr, yi = kc.fn(words0, words, x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mix_resample_mc"] == before["mix_resample_mc"] + 1
    pr, pi = krs.mix_resample_plain(words0, words, x, torch.as_tensor(hc, device=dev), 3, 4,
                                    384, kc.hist)
    assert _rel((yr, yi), (pr, pi)) < 1e-5
    for c in (0, channels - 1):
        r1, i1 = k1.fn(words0[c], words[c], x[c])
        assert torch.equal(r1, yr[c]) and torch.equal(i1, yi[c])
    h = n // 2
    ar, ai = kc.fn(words0, words, x[..., :kc.hist + h].contiguous())
    br, bi = kc.fn([(w0 + h * w) % (1 << 32) for w0, w in zip(words0, words)], words,
                   x[..., h:].contiguous())
    assert torch.equal(torch.cat([ar, br], 1), yr) and torch.equal(torch.cat([ai, bi], 1), yi)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_resample_preframed_matches_plain_and_k8(dev, dtype):
    """K9 over K6 frames against its plain version (rel L2 < 1e-5), K9 == K8
    bit for bit on the same f32 stream, bf16 ingest > 40 dB against f32."""
    hc = krs.combine_fir_resample_taps(lowpass(128, 0.2), lowpass(48, 0.3), 3)
    word = int(freq_to_word(0.07))
    fn, hist, stride, span = krp.make_resample_preframed_kernel(
        hc, word, 3, 4, out_tile=1152, b_rows=8, in_dtype=dtype, device=dev)
    k8 = krs.make_mix_resample_kernel(hc, 3, 4, out_tile=384, b_rows=24, device=dev)
    x = _c2_planes(dev, 1, hist, 4 * 8 * stride)[0]
    w0 = (-hist * word) % (1 << 32)
    xr_f, xi_f = kpf.make_frame_kernel(stride, span, b_rows=8, in_dtype=dtype, device=dev)(
        x.to(dtype))
    counter = "resample_preframed" + ("_bf16" if dtype == BF16 else "")
    before = _build.LAUNCHES[counter]
    yr, yi = fn(w0, xr_f, xi_f)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 1
    pr, pi = krp.resample_preframed_plain(w0, word, xr_f, xi_f, torch.as_tensor(hc, device=dev),
                                          3, 4, 1152, hist)
    assert _rel((yr, yi), (pr, pi)) < 1e-5
    r8, i8 = krs.mix_resample(k8, w0, word, x)
    if dtype == torch.float32:
        assert torch.equal(yr.reshape(-1), r8[0]) and torch.equal(yi.reshape(-1), i8[0])
    else:
        ref = torch.complex(r8[0], i8[0])
        err = torch.complex(yr.reshape(-1), yi.reshape(-1)) - ref
        assert float(10 * torch.log10(ref.abs().pow(2).mean() / err.abs().pow(2).mean())) > 40


RESAMPLE_PAIRS = [(3, 4), (1, 2), (2, 3), (5, 4), (2, 1), (4, 3)]


def test_resample_kernels_no_spills_resident(dev):
    """ptxas reports no spill in any K8/K9 instantiation (4 decims x 4
    sources), each within 64 registers (local memory only the stack frame
    of the staging call, at most 64 bytes), and every up/down pair's (and
    the config-2 geometry's) block keeps at least 2 resident an SM."""
    _build.load()
    found = _spills(r"resample_kernel")
    assert len(found) == 16
    assert not {k: v for k, v in found.items() if v[1] or v[2] or v[0] > 64}, found
    for up, down, t in [(3, 4, 429)] + [(u, d, 48) for u, d in RESAMPLE_PAIRS]:
        hist = krs.resample_geometry(t, up, down, 128 * up)[0]
        for frames, bf16 in ((False, False), (True, False), (True, True)):
            regs, local, blocks = krs.kernel_info(up, down, t, hist, frames, bf16)
            assert regs <= 64 and local <= 64 and blocks >= 2, (up, down, frames, bf16, regs,
                                                                local, blocks)


@pytest.mark.parametrize("up,down", RESAMPLE_PAIRS)
def test_resample_k9_equals_k8_partial_last_block(dev, up, down):
    """K8 and K9 over 37 rows (several per block, the last block partial
    where the block's outputs do not divide NT*OT), against their plain
    versions (rel L2 < 1e-5), K9 == K8 bit for bit on the same stream."""
    t = 429 if (up, down) == (3, 4) else 48
    taps = (krs.combine_fir_resample_taps(lowpass(128, 0.2), lowpass(48, 0.3), 3)
            if t == 429 else lowpass(t, 0.3 / max(up, down)))
    hist = krs.resample_geometry(t, up, down, 128 * up)[0]
    ot = next(o for o in range(up, 1 << 14, up)  # K9 frames: hist | stride = ot*down/up
              if o * down % up == 0 and o * down // up % hist == 0)
    nt = 37
    word = int(freq_to_word(0.07))
    w0 = (-hist * word) % (1 << 32)
    k8 = krs.make_mix_resample_kernel(taps, up, down, out_tile=ot, b_rows=1, device=dev)
    fn9, h9, stride, span = krp.make_resample_preframed_kernel(taps, word, up, down, out_tile=ot,
                                                               b_rows=1, device=dev)
    assert h9 == hist == k8.hist and stride == ot * down // up
    x = _c2_planes(dev, 1, hist, nt * stride, seed=up * 10 + down)[0]
    y8 = k8.fn(w0, word, x)
    fr = kpf.frame_planes(x, stride, span)
    y9 = fn9(w0, fr[0], fr[1])
    torch.cuda.synchronize()
    assert torch.equal(y9[0], y8[0]) and torch.equal(y9[1], y8[1])
    pr, pi = krs.mix_resample_plain(w0, word, x[None], torch.as_tensor(taps, device=dev), up,
                                    down, ot, hist)
    assert _rel(y8, (pr[0], pi[0])) < 1e-5


def test_cuda_wrong_dtype_raises_before_launch(dev):
    k = kmc.make_mix_fir_ctaps_kernel(lowpass(64, 0.2), 1 << 28, 2, out_tile=OT, b_rows=8,
                                      device=dev)
    x = torch.zeros((2, k.hist + k.block_in()), dtype=BF16, device=dev)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="in_dtype"):
        k.fn(0, x)
    assert _build.LAUNCHES == before


def _snr(ref, got) -> float:
    return float(10 * torch.log10(ref.abs().pow(2).mean() / (got - ref).abs().pow(2).mean()))


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("order", [True, False, "kernel"])
def test_fft_kernel_matches_plain(dev, n, order):
    """K10 in each output order against its plain version (rel L2 < 1e-5) and
    against torch.fft in complex128 (SNR > 110 dB); natural == digit + the
    unscramble bit for bit."""
    from srcdsp_tpu_torch.kernels import fft_pallas as kfft

    k = kfft.make_fft_kernel(n, b_frames=4, natural_order=order, device=dev)
    x = np.random.default_rng(n).standard_normal((2, 8, n)).astype(np.float32)
    xr, xi = (torch.as_tensor(a, device=dev) for a in x)
    counter = {True: "fft", False: "fft_digit", "kernel": "fft_nat"}[order]
    before = _build.LAUNCHES[counter]
    yr, yi = k.fn(xr, xi)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 1
    pr, pi = kfft.fft_rows_plain(xr.reshape(-1, k.n2), xi.reshape(-1, k.n2), k.consts, k.n1,
                                 k.n2)
    if order is not False:
        pr, pi = kfft.unscramble(pr, k.n1, k.n2), kfft.unscramble(pi, k.n1, k.n2)
    assert _rel((yr, yi), (pr, pi)) < 1e-5
    nat = k.fn(xr, xi) if order is not False else (kfft.unscramble(yr, k.n1, k.n2),
                                                  kfft.unscramble(yi, k.n1, k.n2))
    ref = torch.fft.fft(torch.complex(xr.double(), xi.double()), dim=-1)
    assert _snr(ref, torch.complex(*nat).to(torch.complex128)) > 110
    dig = kfft.make_fft_kernel(n, b_frames=4, natural_order=False, device=dev).fn(xr, xi)
    knat = kfft.make_fft_kernel(n, b_frames=4, natural_order="kernel", device=dev).fn(xr, xi)
    for d, kn in zip(dig, knat):
        assert torch.equal(kfft.unscramble(d, k.n1, k.n2), kn)


def test_fft_natural_order_is_one_launch_and_no_transpose(dev, monkeypatch):
    """natural_order=True launches the kernel's natural store once and never
    reaches the digit-order unscramble (a torch transpose)."""
    from srcdsp_tpu_torch.kernels import fft_pallas as kfft

    k = kfft.make_fft_kernel(4096, b_frames=16, natural_order=True, device=dev)
    x = np.random.default_rng(7).standard_normal((2, 32, 4096)).astype(np.float32)
    xr, xi = (torch.as_tensor(a, device=dev) for a in x)
    ref = kfft.make_fft_kernel(4096, b_frames=16, natural_order="kernel", device=dev).fn(xr, xi)

    def no_transpose(*args):
        raise AssertionError("natural_order=True ran the unscramble transpose")

    monkeypatch.setattr(kfft, "unscramble", no_transpose)
    before = dict(_build.LAUNCHES)
    yr, yi = k.fn(xr, xi)
    torch.cuda.synchronize()
    after = dict(_build.LAUNCHES)
    assert after.pop("fft") == before.pop("fft") + 1 and after == before
    assert yr.is_contiguous() and tuple(yr.shape) == (32, 4096)
    assert torch.equal(yr, ref[0]) and torch.equal(yi, ref[1])


@pytest.mark.parametrize("n", [256, 2048])
def test_fft_kernel_short_last_block(dev, n):
    """B not a multiple of the frames a block takes (16 at 256, 2 at 2048):
    the frames of the short last block are right."""
    from srcdsp_tpu_torch.kernels import fft_pallas as kfft

    k = kfft.make_fft_kernel(n, b_frames=1, natural_order="kernel", device=dev)
    x = np.random.default_rng(n + 5).standard_normal((2, 4, n)).astype(np.float32)
    full = [torch.as_tensor(a, device=dev) for a in x]
    yr, yi = k.fn(full[0][:3], full[1][:3])
    ref = torch.fft.fft(torch.complex(full[0][:3].double(), full[1][:3].double()), dim=-1)
    assert _snr(ref, torch.complex(yr, yi).to(torch.complex128)) > 110


def test_fft_occupancy_at_least_four_blocks_at_4096(dev):
    from srcdsp_tpu_torch.kernels import fft_pallas as kfft

    assert kfft.fft_occupancy(4096) >= 4
    assert all(kfft.fft_occupancy(1 << m) >= 2 for m in range(8, 14))


@pytest.mark.parametrize("fft,n2,num_taps", [(256, 16, 17), (512, 32, 33), (1024, 64, 65),
                                           (2048, 128, 200), (4096, 128, 1024),
                                           (8192, 128, 1024)])
@pytest.mark.parametrize("per_channel", [False, True])
def test_fftconv_kernel_matches_plain_and_streams(dev, per_channel, fft, n2, num_taps):
    """K11 at every N the card takes (1024 taps at fft 4096) against its plain
    version (SNR > 100 dB), chunked launches and FftConvStream equal to one
    launch bit for bit; 2 blocks of 256 threads resident per SM below 8192."""
    from srcdsp_tpu_torch.kernels import fftconv_pallas as kfc

    c = 3
    taps = (np.stack([lowpass(num_taps, 0.05 + 0.02 * i) for i in range(c)]) if per_channel
            else lowpass(num_taps, 0.1))
    k = kfc.make_fftconv_kernel(taps, fft, num_channels=c, n2=n2, b_frames=4, karatsuba=True,
                                device=dev)
    assert kfc.kernel_info(fft)[2] >= (1 if fft == 8192 else 2)
    n = 4 * k.block_in()
    raw = torch.as_tensor(np.random.default_rng(1).standard_normal((c, 2, n)).astype(np.float32),
                          device=dev)
    x = torch.cat([torch.zeros((c, 2, k.overlap), device=dev), raw], dim=-1)
    counter = "fftconv_per_channel" if per_channel else "fftconv"
    before = _build.LAUNCHES[counter]
    yr, yi = kfc.fftconv_pallas(k, x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 1
    h2 = torch.as_tensor(kfc.freq_response_planes(taps, fft), device=dev)
    from srcdsp_tpu_torch.ops.fft_planes import make_fft_planes
    pr, pi = kfc.fftconv_plain(x, h2, make_fft_planes(fft, device=dev), fft, k.hop)
    assert _snr(torch.complex(pr, pi), torch.complex(yr, yi)) > 100
    st = kfc.FftConvStream(k)
    parts = [st.process(raw[..., i * k.block_in():(i + 1) * k.block_in()].contiguous())
             for i in range(4)]
    assert torch.equal(torch.cat([p[0] for p in parts], -1), yr)
    assert torch.equal(torch.cat([p[1] for p in parts], -1), yi)


def test_cuda_tensor_with_cpu_fft_kernels_raises(dev):
    from srcdsp_tpu_torch.kernels import fft_pallas as kfft
    from srcdsp_tpu_torch.kernels import fftconv_pallas as kfc

    k = kfft.make_fft_kernel(1024, b_frames=1, device="cpu")
    x = torch.zeros((1, 1024), device=dev)
    with pytest.raises(ValueError, match="kernel built for cpu"):
        k.fn(x, x)
    kc = kfc.make_fftconv_kernel(lowpass(64, 0.2), 2048, b_frames=1, device="cpu")
    with pytest.raises(ValueError, match="kernel built for cpu"):
        kfc.fftconv_pallas(kc, torch.zeros((1, 2, kc.overlap + kc.block_in()), device=dev))
    with pytest.raises(ValueError, match="n2 % 128 == 0 and n1 % 8 == 0"):
        kfft.make_fft_kernel(1536, device=dev)


@pytest.mark.parametrize("n,n2", [(3072, 384), (5120, 128), (11264, 128), (12288, 128),
                                  (16384, 128), (17408, 128), (21504, 128), (65536, 128),
                                  (1 << 20, 1024), (1024 * 1021, 128), (27 << 15, 128)])
def test_fft_mixed_and_four_step_match_plain(dev, n, n2):
    """K10 at the sizes past the powers of two (one block a frame up to
    16384, the four-step from 17408; 21 split across two register lines at
    21504; 17, 1021 and 27 x 32 on Bluestein lines) in its
    three orders against its plain version (rel L2 < 1e-5) and complex128
    (> 110 dB);
    kernel-natural == natural == digit unscrambled by torch.equal; one body
    launch a call (the four-step: 2), and no count but the body's moves."""
    from srcdsp_tpu_torch.kernels import fft_pallas as kfft

    plan = kfft.fft_plan(n, n2)
    body = "fft_mixed" if plan.body == "mixed" else "fft_4step"
    b = max(2, (1 << 19) // n)
    g = torch.Generator(device=dev).manual_seed(n)
    xr, xi = (torch.randn((b, n), device=dev, generator=g) for _ in range(2))
    outs = {}
    for order in (True, False, "kernel"):
        k = kfft.make_fft_kernel(n, n2=n2, b_frames=1, natural_order=order, device=dev)
        before = dict(_build.LAUNCHES)
        outs[order] = k.fn(xr, xi)
        after = dict(_build.LAUNCHES)
        assert after.pop(body) == before.pop(body) + (1 if body == "fft_mixed" else 2)
        assert after == before
    pr, pi = kfft.fft_rows_plain(xr.reshape(-1, n2), xi.reshape(-1, n2), k.consts, k.n1, n2)
    plain = torch.complex(kfft.unscramble(pr, k.n1, n2), kfft.unscramble(pi, k.n1, n2))
    nat = torch.complex(*outs[True])
    assert float(torch.linalg.norm(nat - plain) / torch.linalg.norm(plain)) < 1e-5
    ref = torch.fft.fft(torch.complex(xr.double(), xi.double()), dim=-1)
    assert _snr(ref, nat.to(torch.complex128)) > 110
    for a, c, d in zip(outs[True], outs["kernel"], outs[False]):
        assert torch.equal(a, c)
        assert torch.equal(kfft.unscramble(d.reshape(-1, n2), k.n1, n2), a)


def test_fft_four_step_short_last_batch(dev, monkeypatch):
    """The four-step in batches of 2 frames over 5 (a short last batch)
    equals one batch bit for bit, in both stores, at its first size."""
    from srcdsp_tpu_torch.kernels import fft_pallas as kfft

    n = kfft.FOUR_STEP_MIN
    g = torch.Generator(device=dev).manual_seed(3)
    xr, xi = (torch.randn((5, n), device=dev, generator=g) for _ in range(2))
    for order in (True, False):
        k = kfft.make_fft_kernel(n, b_frames=1, natural_order=order, device=dev)
        one = k.fn(xr, xi)
        monkeypatch.setattr(kfft, "SCRATCH_BYTES", 2 * 2 * 4 * n)
        before = _build.LAUNCHES["fft_4step"]
        batched = k.fn(xr, xi)
        assert _build.LAUNCHES["fft_4step"] == before + 6
        monkeypatch.undo()
        assert all(torch.equal(a, c) for a, c in zip(one, batched))


@pytest.mark.parametrize("fft,num_taps", [(11264, 1000), (12288, 3000), (16384, 4096),
                                          (17408, 4352), (21504, 5376), (1024 * 1021, 4096),
                                          (27 << 15, 4096)])
@pytest.mark.parametrize("per_channel", [False, True])
def test_fftconv_mixed_and_four_step_match_plain_and_stream(dev, monkeypatch, per_channel,
                                                             fft, num_taps):
    """K11 on the new bodies (one block a frame up to 16384, the four-step
    from 17408, 21 split across two register lines at 21504, 17, 1021 and
    27 x 32 on Bluestein lines) against its plain version (SNR > 100
    dB), 4 FftConvStream chunks == one launch bit for bit, one launch a call
    (the four-step: 3 a batch of frames within SCRATCH_BYTES), and for the
    four-step a launch in batches of 3 frames (a short last batch) == one
    batch."""
    from srcdsp_tpu_torch.kernels import fft_pallas as kfft
    from srcdsp_tpu_torch.kernels import fftconv_pallas as kfc
    from srcdsp_tpu_torch.ops.fft_planes import make_fft_planes

    c = 3
    taps = (np.stack([lowpass(num_taps, 0.05 + 0.02 * i) for i in range(c)]) if per_channel
            else lowpass(num_taps, 0.1))
    k = kfc.make_fftconv_kernel(taps, fft, num_channels=c, b_frames=2, device=dev)
    raw = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (c, 2, 4 * k.block_in())).astype(np.float32), device=dev)
    x = torch.cat([torch.zeros((c, 2, k.overlap), device=dev), raw], dim=-1)
    mixed = fft < kfft.FOUR_STEP_MIN
    body = "fftconv_mixed" if mixed else "fftconv_4step"
    frames = c * (x.shape[-1] - k.overlap) // k.hop
    before = dict(_build.LAUNCHES)
    yr, yi = kfc.fftconv_pallas(k, x)
    torch.cuda.synchronize()
    after = dict(_build.LAUNCHES)
    assert after.pop(body) == before.pop(body) + (
        1 if mixed else 3 * -(-frames // kfft.scratch_frames(fft, 4)))
    assert after == before
    h2 = torch.as_tensor(kfc.freq_response_planes(taps, fft), device=dev)
    pr, pi = kfc.fftconv_plain(x, h2, make_fft_planes(fft, device=dev), fft, k.hop)
    assert _snr(torch.complex(pr, pi), torch.complex(yr, yi)) > 100
    st = kfc.FftConvStream(k)
    parts = [st.process(raw[..., i * k.block_in():(i + 1) * k.block_in()].contiguous())
             for i in range(4)]
    assert torch.equal(torch.cat([p[0] for p in parts], -1), yr)
    assert torch.equal(torch.cat([p[1] for p in parts], -1), yi)
    if not mixed:
        monkeypatch.setattr(kfft, "SCRATCH_BYTES", 3 * 4 * 4 * fft)
        br, bi = kfc.fftconv_pallas(k, x)
        assert torch.equal(br, yr) and torch.equal(bi, yi)


def test_fft_lines_bodies_no_spill(dev):
    """ptxas reports no spill in any kernel of fft_mixed.cu or fft_4step.cu
    and none uses local memory; at each size of phase 23 each kernel of its
    body keeps the resident threads its launch bounds promise: the one-block
    body floor(1024 / threads) blocks (30, 30, 22, 24 and 32 warps at 3072,
    5120, 11264, 12288 and 16384); the four-step's register lines 32 warps
    (1024 threads) but K11's mid step, which holds two transforms in up to
    128 registers (16 warps); the Bluestein lines' four steps (16 kernels)
    512 threads an SM at least (up to 128 registers)."""
    from srcdsp_tpu_torch.kernels import fft_pallas as kfft

    rep = {k: v for k, v in _build.ptxas_report().items()
           if re.search(r"fft_mixed_kernel|fftconv_mixed_kernel|fft4_|fftconv4_", k)}
    assert len(rep) == (3 * len(kfft.MIXED_SHAPES) + 4 * len(kfft.FOUR_STEP_LINES)
                        + 4 * len(kfft.BLUESTEIN_LOG2M))
    assert sum("bluestein" in k for k in rep) == 4 * len(kfft.BLUESTEIN_LOG2M)
    assert all(st == 0 and ld == 0 for _, st, ld in rep.values()), rep
    for n, n2 in [(3072, 384), (5120, 128), (11264, 128), (12288, 128), (16384, 128),
                  (17408, 128), (65536, 128), (1 << 20, 1024), (1024 * 1021, 128),
                  (27 << 15, 128), (132096, 128)]:
        plan = kfft.fft_plan(n, n2)
        if plan.body == "mixed":
            g = plan.lines[0]
            for name in kfft.MIXED_KERNELS:
                regs, local, blocks = kfft.lines_info(name, g)
                assert local == 0 and blocks >= max(1, 1024 // g.threads), (n, name, regs, blocks)
            continue
        for g, names in zip(plan.lines, (("cols", "out"), ("rows", "mid"))):
            for name in names:
                regs, local, blocks = kfft.lines_info(name, g)
                assert local == 0 and blocks >= 1, (n, name, g, regs, blocks)
                if isinstance(g, kfft.BluesteinLine):
                    assert blocks * g.threads >= 512, (n, name, g, regs, blocks)
                elif name != "mid":
                    assert blocks * g.threads >= 1024, (n, name, g, regs, blocks)


@pytest.mark.parametrize("m,b_k,sps", [(64, 512, 4), (8, 128, 4), (16, 96, 3), (5, 16, 4),
                                        (128, 512, 4), (256, 512, 4), (96, 128, 4)])
def test_bank_kernels_match_plain(dev, m, b_k, sps):
    """K12 and K13 against their plain versions (rel L2 < 1e-5 on Y, stats
    rel L2 < 1e-5), K13's Y == K12's by torch.equal, class-major == the
    standard lanes permuted, and two launches over halves (each with its
    hist_cols history columns) == one launch."""
    from srcdsp_tpu_torch.chains.channelizer import design_prototype
    from srcdsp_tpu_torch.kernels import bank_pallas as kb

    h = design_prototype(m, 8)
    k12, hc = kb.make_bank_kernel(h, m, b_k=b_k, device=dev)
    k13, _ = kb.make_bank_psk_kernel(h, m, sps=sps, b_k=b_k, device=dev)
    k13c, _ = kb.make_bank_psk_kernel(h, m, sps=sps, b_k=b_k, class_major=True, device=dev)
    k = 4 * b_k
    x = torch.as_tensor(np.random.default_rng(m).standard_normal((2, m, hc + k)),
                        dtype=torch.float32, device=dev)
    before = dict(_build.LAUNCHES)
    y = k12(x)
    y13, st = k13(x)
    yc, stc = k13c(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bank"] == before["bank"] + 1
    assert _build.LAUNCHES["bank_psk"] == before["bank_psk"] + 2
    fn_cpu, _ = kb.make_bank_psk_kernel(h, m, sps=sps, b_k=b_k, device="cpu")
    py, pst = fn_cpu(x.cpu())
    assert float(torch.linalg.norm(y.cpu() - py) / torch.linalg.norm(py)) < 1e-5
    assert float(torch.linalg.norm(st.cpu() - pst) / torch.linalg.norm(pst)) < 1e-5
    assert torch.equal(y13, y) and torch.equal(stc, st)
    perm = kb.class_major_index(b_k, sps, dev)
    assert torch.equal(yc, y.reshape(2 * m, 4, b_k)[..., perm].reshape(2 * m, k))
    half = k // 2
    a = k12(x[..., :hc + half].contiguous())
    b = k12(x[..., half:].contiguous())
    assert torch.equal(torch.cat([a, b], dim=-1), y)
    a13 = k13c(x[..., :hc + half].contiguous())
    b13 = k13c(x[..., half:].contiguous())
    assert torch.equal(torch.cat([a13[0], b13[0]], dim=-1), yc)
    assert torch.equal(torch.cat([a13[1], b13[1]], dim=0), stc)


def test_bank_kernel_against_oracle(dev):
    """K12 from zero history against the C++ oracle's channelize: > 100 dB."""
    from srcdsp_tpu_torch import oracle
    from srcdsp_tpu_torch.chains.channelizer import design_prototype
    from srcdsp_tpu_torch.kernels import bank_pallas as kb

    m, k = 64, 1024
    h = design_prototype(m, 8)
    fn, hc = kb.make_bank_kernel(h, m, b_k=512, device=dev)
    rng = np.random.default_rng(2)
    xs = (rng.standard_normal(k * m) + 1j * rng.standard_normal(k * m)).astype(np.complex64)
    flat = np.zeros((2, (hc + k) * m), np.float32)
    flat[0, hc * m:], flat[1, hc * m:] = xs.real, xs.imag
    y = fn(kb.phase_major(torch.as_tensor(flat, device=dev), m, hc)).cpu()
    ref = torch.from_numpy(oracle.channelize(xs, h, m))
    assert _snr(ref, torch.complex(y[:m], y[m:])) > 100


def test_cuda_tensor_with_cpu_bank_kernel_raises(dev):
    from srcdsp_tpu_torch.chains.channelizer import design_prototype
    from srcdsp_tpu_torch.kernels import bank_pallas as kb

    fn, hc = kb.make_bank_psk_kernel(design_prototype(8, 4), 8, sps=4, b_k=128, device="cpu")
    with pytest.raises(ValueError, match="kernel built for cpu"):
        fn(torch.zeros((2, 8, hc + 128), device=dev))
    # 128 channels run on the card (the bank once took at most 64), against
    # the plain version
    h = design_prototype(128, 4)
    k12, hc = kb.make_bank_kernel(h, 128, b_k=256, device=dev)
    x = torch.as_tensor(np.random.default_rng(128).standard_normal((2, 128, hc + 512)),
                        dtype=torch.float32, device=dev)
    y = k12(x).cpu()
    py = kb.make_bank_kernel(h, 128, b_k=256, device="cpu")[0](x.cpu())
    assert float(torch.linalg.norm(y - py) / torch.linalg.norm(py)) < 1e-5


def test_bank_kernels_no_spills_resident(dev):
    """ptxas reports no spill in K12 or K13 (K13's local memory is the stack
    frame of cosf/sinf's slow path, taken for no angle of the sps-entry
    table); config 5's tile (64 frames) keeps at least 2 blocks an SM, and
    M = 128, 256 and 96 fit a tile."""
    from srcdsp_tpu_torch.kernels import bank_pallas as kb

    _build.load()
    found = _spills(r"bank_kernel")
    assert len(found) == 2 and not {k: v for k, v in found.items() if v[1] or v[2]}, found
    for stats in (False, True):
        f, regs, local, blocks = kb.kernel_info(64, 8, 512, 4, stats)
        assert f == 64 and blocks >= 2 and (stats or local == 0), (stats, f, regs, local,
                                                                   blocks)
        for m in (128, 256, 96):
            f, _, _, blocks = kb.kernel_info(m, 8, 512, 4, stats)
            assert f == kb.bank_tile(m, 8, 512, 4, stats)[0] and blocks >= 1


# --- the coded tier: K14, K15, K16 -------------------------------------------

def _ldpc_llr(cw: np.ndarray, sigma: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (2.0 / sigma ** 2 * ((1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape))
            ).astype(np.float32)


@pytest.mark.parametrize("irregular", [False, True])
def test_ldpc_edges_kernel_equals_plain(dev, irregular):
    """K14 == plain on the card, bit for bit, on a regular and an irregular H
    (n 120) at B 256; and the serving decoder at an odd B."""
    from srcdsp_tpu_torch.kernels import ldpc_pallas as kl
    from srcdsp_tpu_torch.ldpc import ldpc_encode, make_ldpc_code, make_regular_ldpc

    h = make_regular_ldpc(120, 3, 6, seed=3)
    if irregular:
        h[0, np.flatnonzero(h[0])[0]] = 0
        h[5, np.flatnonzero(h[5])[0]] = 0
    code = make_ldpc_code(h, device=dev)
    plan = kl.plan_edges(h)
    u = torch.as_tensor(np.random.default_rng(1).integers(0, 2, (256, code.k)), device=dev)
    cw = ldpc_encode(code, u)
    llr = torch.as_tensor(_ldpc_llr(cw.cpu().numpy(), 0.6, 2).T.copy(), device=dev)
    before = _build.LAUNCHES["ldpc_edges"]
    post = kl.make_ldpc_kernel(plan, iters=6, device=dev)(llr)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ldpc_edges"] == before + 1
    assert torch.equal(post, kl.ldpc_decode_edges_ref(plan, llr, iters=6))
    bits, info, ok = kl.make_ldpc_decoder(code, plan, iters=10, device=dev)(llr.T[:201])
    assert float(ok.to(torch.float32).mean()) > 0.9
    assert torch.equal(bits[ok], cw[:201][ok])


def _qc_case(dev, z, zero_blocks):
    from srcdsp_tpu_torch.qcldpc import make_qc_base, make_qc_ldpc
    from srcdsp_tpu_torch.ldpc import ldpc_encode

    base = make_qc_base(3, 8, z, seed=2)
    for i, j in zero_blocks:
        base[i, j] = -1
    code = make_qc_ldpc(base, z, device=dev)
    u = torch.as_tensor(np.random.default_rng(4).integers(0, 2, (256, code.k)), device=dev)
    cw = ldpc_encode(code, u)
    return base, code, cw, torch.as_tensor(_ldpc_llr(cw.cpu().numpy(), 0.6, 5), device=dev)


@pytest.mark.parametrize("z", [16, 128])
def test_ldpc_qc_kernel_equals_plain(dev, z):
    """K15 == plain on the card, bit for bit (a zero block at z 16), and the
    two serving entries at an odd B (the ragged last block)."""
    from srcdsp_tpu_torch.kernels import ldpc_pallas as kl

    base, code, cw, llr = _qc_case(dev, z, [(0, 3), (2, 6)] if z == 16 else [])
    plan = kl.plan_qc(base, z)
    lt = llr.T.contiguous()
    before = _build.LAUNCHES["ldpc_qc"]
    post = kl.make_qc_kernel(plan, iters=4, device=dev)(lt)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ldpc_qc"] == before + 1
    assert torch.equal(post, kl.qc_decode_layered_ref(plan, lt, iters=4))
    bits, _, ok = kl.make_qc_decoder(code, plan, iters=4, device=dev)(llr[:199])
    assert torch.equal(bits, (kl.qc_decode_layered_ref(plan, lt[:, :199], 4).T < 0).to(torch.int32))
    bits_t, ok_t = kl.make_qc_decoder_t(code, plan, iters=4, device=dev)(lt[:, :128])
    assert torch.equal(bits_t.T, bits[:128]) and torch.equal(ok_t, ok[:128])


@pytest.mark.parametrize("b", [128, 199, 4096])
def test_ldpc_qc_kernel_phase3_code_equals_plain(dev, b):
    """K15 at the phase-3 code (4x12 dual diagonal, z 128, 41 circulants:
    2 codewords a block and a thread at B 128 and 199, 8 and 4 at 4096),
    == plain bit for bit."""
    from srcdsp_tpu_torch.kernels import ldpc_pallas as kl
    from srcdsp_tpu_torch.qcldpc import make_dual_diagonal_base

    z = 128
    plan = kl.plan_qc(make_dual_diagonal_base(4, 12, z, seed=0), z)
    rng = np.random.default_rng(b)
    llr = torch.as_tensor((4.0 * rng.standard_normal((12 * z, b))).astype(np.float32), device=dev)
    post = kl.make_qc_kernel(plan, iters=6, b_tile=1, device=dev)(llr)
    assert torch.equal(post, kl.qc_decode_layered_ref(plan, llr, iters=6))


@pytest.mark.parametrize("mb,nb,z,deg", [(12, 24, 64, None), (4, 12, 896, None),
                                         (2, 4, 4096, None), (2, 4, 6144, 2), (2, 40, 64, None)])
def test_ldpc_qc_kernel_geometries_equal_plain(dev, mb, nb, z, deg):
    """K15 at every geometry qc_geometry gives: 12 layers of degree up to
    24 (two state words); 2 codewords a block; one, rows looped; one with the
    check state in device memory; a layer of degree 40 (three state words).
    Exact +-0 and tied LLRs among them; == plain."""
    from srcdsp_tpu_torch.kernels import ldpc_pallas as kl

    rng = np.random.default_rng(z)
    if mb == 12:  # random shifts, a third of the circulants zero
        base = np.where(rng.random((mb, nb)) < 0.3, -1, rng.integers(0, z, (mb, nb)))
        base[:, :2] = rng.integers(0, z, (mb, 2))
    elif deg is None:
        base = np.zeros((mb, nb), np.int64)
    else:
        base = -np.ones((mb, nb), np.int64)
        for i in range(mb):
            base[i, i * deg:(i + 1) * deg] = i + 1
    plan = kl.plan_qc(base, z)
    x = (3.0 * rng.standard_normal((nb * z, 5))).astype(np.float32)
    x[:9, 0], x[9:17, 1], x[17:40, 2] = 0.0, -0.0, 1.5
    llr = torch.as_tensor(x, device=dev)
    before = _build.LAUNCHES["ldpc_qc"]
    post = kl.make_qc_kernel(plan, iters=3, b_tile=1, device=dev)(llr)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ldpc_qc"] == before + 1
    assert torch.equal(post, kl.qc_decode_layered_ref(plan, llr, iters=3))


@pytest.mark.parametrize("b", [1, 3, 1024])
def test_ldpc_edges_kernel_phase3_code_equals_plain(dev, b):
    """K14 at the phase-3 code ((3,6), n 504: 8 codewords a block, 4 a
    thread), B of one, three and 1024, == plain bit for bit."""
    from srcdsp_tpu_torch.kernels import ldpc_pallas as kl
    from srcdsp_tpu_torch.ldpc import make_regular_ldpc

    plan = kl.plan_edges(make_regular_ldpc(504, 3, 6, seed=0))
    rng = np.random.default_rng(b)
    llr = torch.as_tensor((4.0 * rng.standard_normal((504, b))).astype(np.float32), device=dev)
    post = kl.make_ldpc_kernel(plan, iters=10, b_tile=1, device=dev)(llr)
    assert torch.equal(post, kl.ldpc_decode_edges_ref(plan, llr, iters=10))


@pytest.mark.parametrize("shape", ["degree1", "degree40", "banded7998"])
def test_ldpc_edges_kernel_degree1_and_one_codeword_equal_plain(dev, shape):
    """K14 on an H with a degree-1 row (its message stays 0), on one with a
    row of degree 40 (its signs past 32 formed again), each with exact +-0
    and tied LLRs, and on a banded (3,6) H at n 7998 (one codeword a block,
    rows looped over 1024 threads): == plain bit for bit."""
    from srcdsp_tpu_torch.kernels import ldpc_pallas as kl
    from srcdsp_tpu_torch.ldpc import make_regular_ldpc

    if shape == "degree1":
        h = make_regular_ldpc(120, 3, 6, seed=1)
        h[2, np.flatnonzero(h[2])[1:]] = 0
    elif shape == "degree40":
        h = make_regular_ldpc(120, 3, 6, seed=1)
        h[4, 40:80] = 1
    else:
        h = np.zeros((3999, 7998), np.int8)
        for r in range(3999):
            h[r, (2 * r + np.arange(6)) % 7998] = 1
    rng = np.random.default_rng(2)
    x = (4.0 * rng.standard_normal((h.shape[1], 3))).astype(np.float32)
    x[:9, 0], x[9:17, 1], x[17:40, 2] = 0.0, -0.0, 2.0
    plan = kl.plan_edges(h)
    llr = torch.as_tensor(x, device=dev)
    post = kl.make_ldpc_kernel(plan, iters=5, b_tile=1, device=dev)(llr)
    assert torch.equal(post, kl.ldpc_decode_edges_ref(plan, llr, iters=5))


def test_ldpc_kernels_no_spills(dev):
    """ptxas reports no spill in any K14 (codewords a block and a thread 8/4,
    4/4, 2/2, 1/1) or K15 (1, 2 or 4 codewords a thread with the state in
    shared memory, 1 with it in device memory) instantiation."""
    _build.load()
    found = _spills(r"ldpc_(edges|qc)_kernel")
    assert len(found) == 4 + 4, found
    assert not {k: v for k, v in found.items() if v[1] or v[2]}


@pytest.mark.parametrize("t_len,terminated,b", [(67, True, 128), (61, False, 128),
                                                (515, True, 10)])
def test_bcjr_kernel_equals_plain(dev, t_len, terminated, b):
    """K16 == bcjr_decode_batch on the card, bit for bit; B = 10 leaves half
    a block of four codewords empty."""
    from srcdsp_tpu_torch.kernels import bcjr_pallas as kb
    from srcdsp_tpu_torch.turbo import bcjr_decode_batch, make_rsc

    rng = np.random.default_rng(t_len)
    ls, lp = (torch.as_tensor((4.0 * rng.standard_normal((t_len, b))).astype(np.float32),
                              device=dev) for _ in range(2))
    code = make_rsc()
    fn = kb.make_bcjr_kernel(code, t_len, terminated, b_tile=b if b < 128 else 128, device=dev)
    before = _build.LAUNCHES["bcjr"]
    post = fn(ls, lp)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bcjr"] == before + 1
    assert torch.equal(post, bcjr_decode_batch(code, ls, lp, terminated=terminated)[0])


@pytest.mark.parametrize("b", [10, 128, 256, 384])
@pytest.mark.parametrize("t_len", [61, 67, 515])
@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("fb,g", [(0o13, 0o15), (0o15, 0o17), (0o17, 0o13)])
def test_bcjr_kernel_codes_equal_plain(dev, fb, g, terminated, t_len, b):
    """K16 (one codeword a thread, forward and backward warps meeting in the
    middle) == bcjr_decode_batch bit for bit for three codes, an odd and an
    even t, and B off and on whole blocks of 32 codewords."""
    from srcdsp_tpu_torch.kernels import bcjr_pallas as kb
    from srcdsp_tpu_torch.turbo import bcjr_decode_batch, make_rsc

    rng = np.random.default_rng(t_len * b + fb)
    ls, lp = (torch.as_tensor((4.0 * rng.standard_normal((t_len, b))).astype(np.float32),
                              device=dev) for _ in range(2))
    code = make_rsc(4, fb, g)
    fn = kb.make_bcjr_kernel(code, t_len, terminated, b_tile=min(b, 128), device=dev)
    before = _build.LAUNCHES["bcjr"]
    post = fn(ls, lp)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bcjr"] == before + 1
    assert torch.equal(post, bcjr_decode_batch(code, ls, lp, terminated=terminated)[0])


@pytest.mark.parametrize("b", [40, 64])
@pytest.mark.parametrize("t_len", [800, 801])
def test_bcjr_kernel_staged_and_device_memory_inputs(dev, t_len, b):
    """t 800 stages ls and lp in shared memory (200 KB; 16-byte copies at B
    64, one float a copy at B 40, whose last block is part full), t 801
    reads them from device memory: both == bcjr_decode_batch bit for bit."""
    from srcdsp_tpu_torch.kernels import bcjr_pallas as kb
    from srcdsp_tpu_torch.turbo import bcjr_decode_batch, make_rsc

    rng = np.random.default_rng(t_len + b)
    ls, lp = (torch.as_tensor((4.0 * rng.standard_normal((t_len, b))).astype(np.float32),
                              device=dev) for _ in range(2))
    code = make_rsc(4, 0o15, 0o17)
    post = kb.make_bcjr_kernel(code, t_len, True, b_tile=8, device=dev)(ls, lp)
    assert torch.equal(post, bcjr_decode_batch(code, ls, lp, terminated=True)[0])


def test_bcjr_and_rows_kernels_no_spills(dev):
    """ptxas reports no spill in K16 (ls and lp staged in shared memory, or
    not) or in any K18 instantiation (decim 1, 2, 4 and the generic one),
    and the K18 ones keep 4 blocks an SM at 64 taps."""
    from srcdsp_tpu_torch.kernels import mixfir_rows as krw
    _build.load()
    found = _spills(r"bcjr_kernel|rows_kernel")
    assert len(found) == 2 + 4, found  # K16 staged and not
    assert not {k: v for k, v in found.items() if v[1] or v[2]}
    for decim in (1, 2, 4, 3):
        regs, local, blocks = krw.kernel_info(decim, 64, 128)
        assert local == 0 and regs <= 64 and blocks >= 4, (decim, regs, local, blocks)


def test_turbo_pallas_equals_batch_on_card(dev):
    from srcdsp_tpu_torch import configs

    outs = [configs.build_turbo(t=64, iters=2, batch=128, layout=layout, device=dev)
            for layout in configs.TURBO_LAYOUTS]
    got = [b.step(*b.example) for b in outs]
    assert all(torch.equal(a, c) for a, c in zip(*got))


def test_coded_kernels_refuse_bad_input_before_launch(dev):
    """A CUDA tensor meets a CPU-built factory, a wrong dtype or a B off the
    tile: each raises and launches nothing."""
    from srcdsp_tpu_torch.kernels import bcjr_pallas as kb
    from srcdsp_tpu_torch.kernels import ldpc_pallas as kl
    from srcdsp_tpu_torch.ldpc import make_regular_ldpc
    from srcdsp_tpu_torch.qcldpc import make_dual_diagonal_base
    from srcdsp_tpu_torch.turbo import make_rsc

    ep = kl.plan_edges(make_regular_ldpc(120, 3, 6, seed=1))
    qp = kl.plan_qc(make_dual_diagonal_base(4, 12, 16, seed=1), 16)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="kernel built for cpu"):
        kl.make_ldpc_kernel(ep, device="cpu")(torch.zeros((120, 128), device=dev))
    with pytest.raises(ValueError, match="kernel built for cpu"):
        kl.make_qc_kernel(qp, device="cpu")(torch.zeros((192, 128), device=dev))
    with pytest.raises(ValueError, match="kernel built for cpu"):
        kb.make_bcjr_kernel(make_rsc(), 16, True, device="cpu")(
            torch.zeros((16, 128), device=dev), torch.zeros((16, 128), device=dev))
    with pytest.raises(ValueError, match="float32"):
        kl.make_ldpc_kernel(ep, device=dev)(torch.zeros((120, 128), dtype=torch.float64,
                                                        device=dev))
    with pytest.raises(ValueError, match="float32"):
        kl.make_qc_kernel(qp, device=dev)(torch.zeros((192, 128), dtype=BF16, device=dev))
    with pytest.raises(ValueError, match="float32"):
        kb.make_bcjr_kernel(make_rsc(), 16, True, device=dev)(
            torch.zeros((16, 128), device=dev), torch.zeros((16, 128), dtype=BF16, device=dev))
    with pytest.raises(ValueError, match="tile 128"):
        kl.make_ldpc_kernel(ep, device=dev)(torch.zeros((120, 96), device=dev))
    with pytest.raises(ValueError, match="tile 128"):
        kl.make_qc_kernel(qp, device=dev)(torch.zeros((192, 96), device=dev))
    with pytest.raises(ValueError, match="b_tile=128"):
        kb.make_bcjr_kernel(make_rsc(), 16, True, device=dev)(
            torch.zeros((16, 96), device=dev), torch.zeros((16, 96), device=dev))
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("decim,t", [(2, 64), (4, 33)])
def test_ctaps_aligned_equals_k4_and_streams(dev, decim, t):
    """K17 == K4 bit for bit on the same stream (history as its own operand,
    slices of one array), and 4 chunks with carried history == one launch."""
    from srcdsp_tpu_torch.kernels import ctaps_aligned as kca
    taps, word = lowpass(t, 0.4 / decim), int(freq_to_word(0.11))
    ka = kca.make_ctaps_aligned_kernel(taps, word, decim, out_tile=OT, b_rows=8, device=dev)
    k4 = kmc.make_mix_fir_ctaps_kernel(taps, word, decim, out_tile=OT, b_rows=8, device=dev)
    h, n = ka.hist, 8 * ka.block_in()
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((2, h + n)).astype(np.float32),
                        device=dev)
    before = _build.LAUNCHES["ctaps_aligned"]
    yr, yi = kca.ctaps_aligned(ka, 0, x[:, :h], x[:, h:])
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ctaps_aligned"] == before + 1
    rr, ri = kmc.mix_fir_ctaps(k4, (-h * word) % (1 << 32), x)
    assert torch.equal(yr, rr) and torch.equal(yi, ri)
    gr, gi = (torch.as_tensor(g[0], device=dev)
              for g in kct.ctaps_host(taps, [word], decim)[:2])
    pr, pi = kca.ctaps_aligned_plain(0, word, x[:, :h], x[:, h:].reshape(2, -1, OT * decim), gr,
                                     gi, decim, OT, h)
    assert _rel((yr.reshape(pr.shape), yi.reshape(pi.shape)), (pr, pi)) < 1e-5
    q, parts = n // 4, []
    for i in range(4):
        lo = h + i * q
        parts.append(kca.ctaps_aligned(ka, (i * q * word) % (1 << 32), x[:, lo - h:lo],
                                       x[:, lo:lo + q]))
    assert torch.equal(torch.cat([p[0] for p in parts], -1), yr)
    assert torch.equal(torch.cat([p[1] for p in parts], -1), yi)


@pytest.mark.parametrize("t,decim,ot", [(64, 2, 512), (33, 4, 256)])
def test_mixfir_rows_matches_plain_and_k1(dev, t, decim, ot):
    from srcdsp_tpu_torch.kernels import mixfir_rows as krw
    taps, word = lowpass(t, 0.4 / decim), int(freq_to_word(0.11))
    kr = krw.make_mix_fir_rows_kernel(taps, decim, out_tile=ot, b_rows=8, device=dev)
    k1 = kmf.make_mix_fir_kernel(taps, decim, out_tile=ot, b_rows=8, device=dev)
    n = 4 * kr.block_in()
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((2, kr.hist + n))
                        .astype(np.float32), device=dev)
    w0 = (-kr.hist * word) % (1 << 32)
    before = _build.LAUNCHES["mixfir_rows"]
    got = krw.mix_fir_rows(kr, w0, word, x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mixfir_rows"] == before + 1
    x3, _ = krw.rows_view(kr, x)
    plain = krw.mix_fir_rows_plain(w0, word, x3, torch.as_tensor(taps, device=dev), decim, ot,
                                   kr.hist, n)
    assert _rel(got, tuple(p.reshape(1, -1) for p in plain)) < 2e-6
    assert _rel(got, kmf.mix_fir_decim(k1, w0, word, x)) < 2e-6


@pytest.mark.parametrize("t,decim,ot", [(64, 2, 512), (33, 4, 256)])
def test_mixfir_rows_part_full_last_block(dev, t, decim, ot):
    """K18 over 3 rows of b_rows 3: its last block of kOutputs (1024)
    outputs is part full; within rel L2 2e-6 of plain and of K1."""
    from srcdsp_tpu_torch.kernels import mixfir_rows as krw
    taps, word = lowpass(t, 0.4 / decim), int(freq_to_word(-0.173))
    kr = krw.make_mix_fir_rows_kernel(taps, decim, out_tile=ot, b_rows=3, device=dev)
    k1 = kmf.make_mix_fir_kernel(taps, decim, out_tile=ot, b_rows=3, device=dev)
    n = 3 * kr.block_in()
    assert (n // decim) % 1024
    x = torch.as_tensor(np.random.default_rng(t).standard_normal((2, kr.hist + n))
                        .astype(np.float32), device=dev)
    w0 = (-kr.hist * word) % (1 << 32)
    before = _build.LAUNCHES["mixfir_rows"]
    got = krw.mix_fir_rows(kr, w0, word, x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mixfir_rows"] == before + 1
    x3, _ = krw.rows_view(kr, x)
    plain = krw.mix_fir_rows_plain(w0, word, x3, torch.as_tensor(taps, device=dev), decim, ot,
                                   kr.hist, n)
    assert _rel(got, tuple(p.reshape(1, -1) for p in plain)) < 2e-6
    assert _rel(got, kmf.mix_fir_decim(k1, w0, word, x)) < 2e-6


def test_ddc_and_iir_on_cuda_tensors_match_the_cpu(dev):
    from srcdsp_tpu_torch.ops import ddc as oddc
    from srcdsp_tpu_torch.ops import iir as oiir
    ddc = oddc.make_ddc(center=0.21, bandwidth=0.0155)
    n = ddc.decim * 2048
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    _, yc = oddc.ddc_apply(ddc, oddc.ddc_init(ddc, (3,), device=dev),
                           torch.as_tensor(x, device=dev))
    _, yh = oddc.ddc_apply(ddc, oddc.ddc_init(ddc, (3,), device="cpu"), torch.from_numpy(x))
    assert yc.device.type == "cuda"
    assert float(torch.linalg.norm(yc.cpu() - yh) / torch.linalg.norm(yh)) < 1e-5
    b, a = oiir.dc_block_coeffs()
    for form in ("assoc", "scan"):
        pc = oiir.make_iir_params(b, a, device=dev)
        ph = oiir.make_iir_params(b, a, device="cpu")
        _, zc = oiir.iir_apply(pc, oiir.iir_init(pc, (3,), device=dev),
                               torch.as_tensor(x[:, :8192], device=dev), inter_block=form)
        _, zh = oiir.iir_apply(ph, oiir.iir_init(ph, (3,), device="cpu"),
                               torch.from_numpy(x[:, :8192]), inter_block=form)
        assert float(torch.linalg.norm(zc.cpu() - zh) / torch.linalg.norm(zh)) < 1e-5


def _halo_case(dev, p=4, rows=2, per=4096):
    from srcdsp_tpu_torch.dist import mesh as dm
    mesh = dm.make_mesh(time=p, devices=[dev] * p)
    x = torch.as_tensor(np.random.default_rng(rows).standard_normal((rows, p * per))
                        .astype(np.float32), device=dev)
    return mesh, x


@pytest.mark.parametrize("rows,halo", [(2, 128), (32, 1024)])
def test_halo_dma_equals_the_copy_path(dev, rows, halo):
    """K19 on 4 shards of one card, as whole shards and as column slices of
    one wider array (row stride passed to the kernel): one launch per card."""
    from srcdsp_tpu_torch.dist import halo as dh
    from srcdsp_tpu_torch.dist import mesh as dm
    from srcdsp_tpu_torch.kernels import halo_dma as k19
    mesh, x = _halo_case(dev, rows=rows)
    for shards in (dm.shard(x, mesh), tuple(x.chunk(4, dim=-1))):
        before = _build.LAUNCHES["halo_dma"]
        got = k19.halo_from_left_pallas(shards, halo)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["halo_dma"] == before + 1
        ref = dh.halo_from_left(shards, halo)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        assert not bool(got[0].any())


def test_halo_fused_equals_k1_and_the_copy_path(dev):
    """K20 on 4 shards of one card, 2 buffers: == K1 over the unsharded
    stream, == mix_fir_time_sharded, tails equal; the per-shard call == its
    plain version within K1's tolerance."""
    from srcdsp_tpu_torch.dist import fused as df
    from srcdsp_tpu_torch.dist import mesh as dm
    from srcdsp_tpu_torch.kernels import halo_fused as k20
    taps, decim, word = lowpass(64, 0.2), 2, int(freq_to_word(0.11))
    kf = k20.make_halo_fused_kernel(taps, decim, out_tile=OT, b_rows=8, device=dev)
    k1 = kmf.make_mix_fir_kernel(taps, decim, out_tile=OT, b_rows=8, device=dev)
    n = 4 * 2 * k1.block_in()
    mesh, x = _halo_case(dev, per=2 * n // 4)
    tail_a = tail_b = torch.zeros((2, kf.hist), device=dev)
    ya, yb = [], []
    for b in range(2):
        shards = dm.shard(x[:, b * n:(b + 1) * n], mesh)
        w0 = (b * n * word) % (1 << 32)
        before = _build.LAUNCHES["halo_fused"]
        tail_a, y = k20.mix_fir_halo_sharded(kf, w0, word, tail_a, shards, mesh)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["halo_fused"] == before + 4
        ya.append(torch.cat(y, dim=-1))
        tail_b, y = df.mix_fir_time_sharded(k1, w0, word, tail_b, shards, mesh)
        yb.append(torch.cat(y, dim=-1))
    a, b_ = torch.cat(ya, dim=-1), torch.cat(yb, dim=-1)
    xpad = torch.cat([torch.zeros((2, k1.hist), device=dev), x], dim=-1)
    rr, ri = k1.fn((-k1.hist * word) % (1 << 32), word, xpad)
    assert torch.equal(a[0], rr.reshape(-1)) and torch.equal(a[1], ri.reshape(-1))
    assert torch.equal(a, b_) and torch.equal(tail_a, tail_b)
    assert torch.equal(tail_a, x[:, -kf.hist:])
    hist = x[:, :kf.hist].contiguous()
    body = x[:, kf.hist:kf.hist + k1.block_in()].contiguous()
    got = kf.fn(w0, word, hist, body)
    pr, pi = kmf.mix_fir_plain(w0, word, torch.cat([hist, body], dim=-1)[None],
                               torch.as_tensor(taps, device=dev), decim, OT, kf.hist)
    assert _rel(got, (pr[0], pi[0])) < 1e-5


def test_halo_kernels_across_two_cards(dev):
    """The cross-card form: a 2-shard mesh over cuda:0 and cuda:1 with peer
    access; K19 and K20 read the left card's memory in place."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    from srcdsp_tpu_torch.dist import fused as df
    from srcdsp_tpu_torch.dist import halo as dh
    from srcdsp_tpu_torch.dist import mesh as dm
    from srcdsp_tpu_torch.kernels import halo_dma as k19
    from srcdsp_tpu_torch.kernels import halo_fused as k20
    mesh = dm.make_mesh(time=2)
    cards = mesh.axis_devices()
    assert {d.index for d in cards} == {0, 1}
    taps, decim, word = lowpass(64, 0.2), 2, int(freq_to_word(0.11))
    kfs = dm.per_device(lambda d: k20.make_halo_fused_kernel(taps, decim, out_tile=OT, b_rows=8,
                                                             device=d), cards)
    k1s = dm.per_device(lambda d: kmf.make_mix_fir_kernel(taps, decim, out_tile=OT, b_rows=8,
                                                          device=d), cards)
    n = 2 * 4 * k1s[0].block_in()
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((2, n)).astype(np.float32))
    shards = dm.shard(x, mesh)
    got = k19.halo_from_left_pallas(shards, 128)
    ref = dh.halo_from_left(shards, 128)
    assert all(torch.equal(g.cpu(), r.cpu()) for g, r in zip(got, ref))
    assert got[1].device == cards[1]
    tail = torch.zeros((2, kfs[0].hist), device=cards[0])
    ta, ya = k20.mix_fir_halo_sharded(kfs, 0, word, tail, shards, mesh)
    tb, yb = df.mix_fir_time_sharded(k1s, 0, word, tail, shards, mesh)
    assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(ya, yb))
    assert torch.equal(ta, tb) and ta.device == cards[0]
    # a per-shard call on cuda:1 (its history read from cuda:0) leaves the
    # thread's current device as it was
    torch.cuda.set_device(cards[0])
    kfs[1].fn(0, word, shards[0][:, -kfs[1].hist:], shards[1])
    assert torch.cuda.current_device() == cards[0].index


# ---------- the classical FEC tier: plain torch on the card == the CPU run ----------

def _fec_cases():
    from srcdsp_tpu_torch import bch, fec, gf2, golay, hdlc, interleave, polar, rs

    rng = np.random.default_rng(15)
    cc = fec.make_conv_code(7, (0o171, 0o133))
    u = rng.integers(0, 2, (8, 200))
    coded = fec.conv_encode(cc, torch.as_tensor(u)).numpy()
    soft = ((1.0 - 2.0 * coded) + 0.8 * rng.standard_normal(coded.shape)).astype(np.float32)
    rs_msg = rng.integers(0, 256, (8, 223), dtype=np.uint8)
    rs_cw = rs.rs_encode(rs.make_rs_code(device="cpu"), torch.as_tensor(rs_msg)).numpy()
    rs_rx = rs_cw.copy()
    for row, ne in zip(rs_rx, (0, 1, 8, 15, 16, 17, 20, 30)):
        row[rng.choice(255, ne, replace=False)] ^= rng.integers(1, 256, ne).astype(np.uint8)
    bch_rx = rng.integers(0, 2, (64, 31))
    pc = polar.make_polar(64, 32)
    llr = (4.0 * rng.standard_normal((16, 64))).astype(np.float32)
    hd = (rng.random(3000) < 0.8).astype(np.int32)
    crc = gf2.make_crc(0x04C11DB7, 32, 0xFFFFFFFF, 0xFFFFFFFF, reflect=True)
    scr = gf2.make_scrambler((4, 7), 7)
    bits = rng.integers(0, 2, (4, 1500))
    t = torch.as_tensor
    return {
        "conv_encode": lambda d: [fec.conv_encode(cc, t(u, device=d))],
        "viterbi_soft": lambda d: [fec.viterbi_decode(cc, t(soft, device=d))],
        "viterbi_ties_open": lambda d: [fec.viterbi_decode(cc, t(np.round(soft), device=d),
                                                           terminated=False)],
        "viterbi_hard": lambda d: [fec.viterbi_decode_hard(cc, t(soft < 0, device=d))],
        "rs_decode": lambda d: list(rs.rs_decode(rs.make_rs_code(device=d), t(rs_rx, device=d))),
        "bch_decode": lambda d: list(bch.bch_decode(bch.make_bch_code(5, 2, device=d),
                                                    t(bch_rx, device=d))),
        "golay_decode": lambda d: list(golay.golay_decode(golay.make_golay(),
                                                          t(bch_rx[:, :24], device=d))),
        "polar_sc": lambda d: list(polar.polar_decode(pc, t(llr, device=d))),
        "polar_scl": lambda d: list(polar.polar_decode_list(pc, t(llr, device=d), 8)),
        "polar_scl_onehot_fast": lambda d: list(polar.polar_decode_list_onehot(
            pc, t(llr, device=d), 8, fast=True)),
        "crc32": lambda d: [gf2.crc_value(crc, gf2.crc_update(crc, gf2.crc_init(crc, device=d),
                                                             t(bits, device=d)))],
        "scramble": lambda d: list(gf2.scramble(scr, gf2.gf2_init(scr, 0x5D, device=d),
                                                t(bits, device=d))),
        "hdlc": lambda d: (list(hdlc.stuff_bits(t(hd, device=d), 3))
                           + list(hdlc.destuff_bits(t(hd, device=d), 2))
                           + [hdlc.find_flags(t(hd, device=d))]),
        "interleave": lambda d: [interleave.block_interleave(t(rs_cw[:4].reshape(1, -1), device=d),
                                                             4, 255)],
    }


@pytest.mark.parametrize("name", sorted(_fec_cases()))
def test_fec_tier_on_card_equals_cpu(dev, name):
    """Each decoder and coder of the FEC tier at a small shape: the card's
    result torch.equal to the CPU run on the same inputs."""
    run = _fec_cases()[name]
    got, want = run(dev), run(torch.device("cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)


def test_fec_branch_metrics_and_onehot_with_tf32_allowed(dev):
    """With TF32 allowed globally, the Viterbi branch metrics (products by
    +-1, summed in order: no matmul) and decisions equal the CPU's, and the
    one-hot SCL entry point equals the gather form and the CPU's SCL."""
    from srcdsp_tpu_torch import fec, polar

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        cc = fec.make_conv_code(7, (0o171, 0o133))
        r = torch.as_tensor(np.random.default_rng(3).standard_normal((4, 300, 2)).astype(np.float32))
        assert torch.equal(fec.branch_metrics(cc, r.to(dev)).cpu(), fec.branch_metrics(cc, r))
        soft = r.reshape(4, 600)
        assert torch.equal(fec.viterbi_decode(cc, soft.to(dev)).cpu(), fec.viterbi_decode(cc, soft))
        pc = polar.make_polar(128, 64)
        llr = torch.as_tensor((3.0 * np.random.default_rng(4).standard_normal((32, 128))).astype(
            np.float32), device=dev)
        torch.backends.cuda.matmul.allow_tf32 = True
        onehot = polar.polar_decode_list_onehot(pc, llr, 8, fast=True)
        gather = polar.polar_decode_list(pc, llr, 8)
        on_cpu = polar.polar_decode_list(pc, llr.cpu(), 8)
        assert len(onehot) == len(gather) == len(on_cpu) == 3
        for a, b, c in zip(onehot, gather, on_cpu):
            assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _ofdm_link(c=2, nw=64, z=16, order=16, snr_db=15.0, n_pilot=4, seed=0):
    """Coded-OFDM planes (bench/ofdm_modem_onchip.py's transmit side, port
    only): c channels x nw codewords of the 4 x 12 dual-diagonal code after
    n_pilot pilot symbols."""
    from srcdsp_tpu_torch.chains import modem as tm
    from srcdsp_tpu_torch.chains import ofdm as to
    from srcdsp_tpu_torch.chains.qam import qam_constellation
    from srcdsp_tpu_torch.kernels.ldpc_pallas import plan_qc
    from srcdsp_tpu_torch.qcldpc import (make_dual_diagonal_base, make_qc_ldpc,
                                         qc_encode_dual_diagonal)

    base = make_dual_diagonal_base(4, 12, z, seed=0)
    n, k = 12 * z, 8 * z
    spc = n // 4
    spec = to.make_ofdm_spec(64, 16, 52, order)
    rng = np.random.default_rng(seed)
    cw = qc_encode_dual_diagonal(base, z, torch.as_tensor(rng.integers(0, 2, (c * nw, k))))
    idx = tm.map_codewords_to_symbols(cw, order).numpy().reshape(c, nw * spc)
    pts = qam_constellation(order)
    s_data = -(-(nw * spc) // 52)
    fill = rng.integers(0, order, (c, s_data * 52 - nw * spc))
    grid = pts[np.concatenate([idx, fill], axis=1)].reshape(c, s_data, 52)
    pilot = pts[rng.integers(0, order, 52)]
    tx = to.ofdm_modulate(spec, torch.as_tensor(
        np.concatenate([np.broadcast_to(pilot, (c, n_pilot, 52)), grid], axis=1).reshape(-1, 52)))
    tx = tx.numpy().reshape(c, -1)
    y = np.stack([np.convolve(t, [1.0, 0.2 * np.exp(0.5j)])[: t.size] for t in tx])
    y = y + 10 ** (-snr_db / 20) / np.sqrt(2) * (rng.standard_normal(y.shape)
                                                 + 1j * rng.standard_normal(y.shape))
    planes = [torch.as_tensor(np.ascontiguousarray(a, np.float32))
              for a in (y.real, y.imag, pilot.real, pilot.imag)]
    return spec, make_qc_ldpc(base, z, device="cpu"), plan_qc(base, z), cw, planes


def test_ofdm_modem_k15_path_equals_plain(dev):
    """make_ofdm_coded_modem on the card launches K15 once a call (no
    fallback) and equals its CPU run, whose decoder is K15's plain version:
    bits and ok torch.equal, decoded == transmitted."""
    from srcdsp_tpu_torch.chains.ofdm_modem import make_ofdm_coded_modem

    spec, code, plan, cw, planes = _ofdm_link()
    kw = dict(num_channels=2, nw=64, iters=6, b_tile=128, n_pilot=4)
    on_card = type(code)(*(f.to(dev) if isinstance(f, torch.Tensor) else f for f in code))
    card = make_ofdm_coded_modem(spec, on_card, plan, device=dev, **kw)
    before = _build.LAUNCHES["ldpc_qc"]
    bits, ok = card(*(p.to(dev) for p in planes))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ldpc_qc"] == before + 1
    bits_c, ok_c = make_ofdm_coded_modem(spec, code, plan, device="cpu", **kw)(*planes)
    assert torch.equal(bits.cpu(), bits_c) and torch.equal(ok.cpu(), ok_c)
    assert bool(ok_c.all()) and torch.equal(bits_c.T, cw.to(torch.int32))


@pytest.mark.parametrize("which", ["ofdm", "scfde"])
def test_dft_receivers_pin_f32_with_tf32_allowed(dev, which):
    """With TF32 allowed globally, the DFT-matmul receivers still run their
    matmuls in float32: indices equal to the CPU run, soft planes within rel
    L2 1e-5 (TF32 would miss by about 1e-3)."""
    from srcdsp_tpu_torch.chains import ofdm_planes, scfde, scfde_planes
    from srcdsp_tpu_torch.chains.qam import qam_constellation

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        if which == "ofdm":
            spec, _, _, _, planes = _ofdm_link(nw=8)
            rx = {d: ofdm_planes.make_ofdm_rx_planes(spec, n_pilot=4, device=d)
                  for d in (dev, "cpu")}
        else:
            sp = scfde.make_scfde_spec(256, 32, device="cpu")
            rng = np.random.default_rng(1)
            sym = qam_constellation(4)[rng.integers(0, 4, (2, 64, 256))]
            tx = np.stack([scfde.scfde_tx(sp, torch.as_tensor(s)).numpy() for s in sym])
            y = np.stack([np.convolve(t, [1.0, 0.0, 0.45 * np.exp(1.1j)])[: t.size] for t in tx])
            planes = [torch.as_tensor(np.ascontiguousarray(a, np.float32)) for a in (y.real, y.imag)]
            rx = {d: scfde_planes.make_scfde_rx_planes(
                scfde.make_scfde_spec(256, 32, device=d), snr=200.0, device=d) for d in (dev, "cpu")}
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        idx, (zr, zi) = rx[dev](*(p.to(dev) for p in planes))
        cidx, (czr, czi) = rx["cpu"](*planes)
        assert torch.equal(idx.cpu(), cidx)
        for a, b in ((zr, czr), (zi, czi)):
            assert float(torch.linalg.norm(a.cpu() - b) / torch.linalg.norm(b)) <= 1e-5
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def test_sync_tier_on_card_matches_cpu(dev):
    """The open-loop tracker, the OOK chain and a closed-loop plane tracker
    at small shapes: decisions on the card equal the CPU run's (the closed
    loop within a 1e-3 mismatch fraction: FMA contraction differs)."""
    from srcdsp_tpu_torch.chains import feedforward, ook, psk, tracking_planes
    from srcdsp_tpu_torch.ops.resample import resample_full
    from srcdsp_tpu_torch.testing.signals import ook_baseband

    rng = np.random.default_rng(2)
    taps = psk.make_psk_params(0.0, 1, 4, 4, device="cpu").taps
    sym = np.exp(2j * np.pi * (rng.integers(0, 4, (2, 2112)) + 0.5) / 4).astype(np.complex64)
    x = resample_full(taps, torch.as_tensor(sym), up=4, down=1)[:, :8192]
    yr, yi = x.real.contiguous(), x.imag.contiguous()
    got = feedforward.ff_psk_demod_ragged(yr.to(dev), yi.to(dev), 4, 4, block=128, offset=0.5)
    want = feedforward.ff_psk_demod_ragged(yr, yi, 4, 4, block=128, offset=0.5)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[2].cpu(), want[2])
    xo = torch.as_tensor(ook_baseband(rng.integers(0, 2, (2, 512)), 8, rise=3))
    par = ook.make_ook_params(8)
    assert torch.equal(ook.ook_demod_full(par, xo.to(dev))[0].cpu(), ook.ook_demod_full(par, xo)[0])
    pp = {d: psk.make_psk_params(0.0, 1, 4, 4, device=d) for d in (dev, "cpu")}
    planes = torch.stack([yr, yi], dim=1)[:, :, :4096]
    outs = {}
    for d in (dev, "cpu"):
        st = tracking_planes.psk_track_planes_init(pp[d], 2)
        outs[d] = [tracking_planes.psk_track_planes_apply(pp[d], st, planes.to(d))[1][0].cpu()]
    assert float((outs[dev][0] != outs["cpu"][0]).float().mean()) <= 1e-3


def _css_link(frames=16, snr=-8.0, sf=8):
    from srcdsp_tpu_torch.chains import css

    rng = np.random.default_rng(3)
    p = css.make_css_params(sf=sf, cr=4)
    pls = [bytes(rng.integers(0, 256, 20, dtype=np.uint8)) for _ in range(frames)]
    x = css.css_modulate(p, np.concatenate([css.css_encode_frame(p, q) for q in pls]))
    sigma = np.sqrt(10 ** (-snr / 10) / 2)
    x = (x + sigma * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
         ).astype(np.complex64)
    fr = x.reshape(-1, p.n)
    planes = [torch.as_tensor(np.ascontiguousarray(a, np.float32)) for a in (fr.real, fr.imag)]
    return p, pls, x, planes


@pytest.mark.parametrize("tf32", [False, True])
def test_css_link_on_card_equals_cpu(dev, tf32):
    """The coded CSS link at 16 frames, -8 dB: the LLR planes on the card
    within rel L2 1e-5 of the CPU run (also with TF32 allowed globally: the
    folded DFT products stay float32), the batch decode on the card equal to
    the CPU's (payloads and flags), every frame back; the demod planes
    (direct and four-step) give the CPU's shifts."""
    from srcdsp_tpu_torch.chains import css, css_planes

    p, pls, _, planes = _css_link()
    nsym = css.css_frame_nsym(p, 20)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        llr = {d: css_planes.make_css_llr_planes(p, device=d)(*(a.to(d) for a in planes))
               for d in (dev, "cpu")}
        assert float(torch.linalg.norm(llr[dev].cpu() - llr["cpu"])
                     / torch.linalg.norm(llr["cpu"])) <= 1e-5
        out = {d: css.css_decode_frames_soft_batch(p, llr[d].reshape(-1, nsym, p.sf), 20)
               for d in (dev, "cpu")}
        assert out[dev][0] == out["cpu"][0] == pls
        assert out[dev][1].all() and (out[dev][1] == out["cpu"][1]).all()
        for direct in (True, False):
            k = {d: css_planes.make_css_demod_planes(p, direct=direct, device=d)(
                *(a.to(d) for a in planes))[0] for d in (dev, "cpu")}
            assert torch.equal(k[dev].cpu(), k["cpu"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def test_css_receive_stream_on_card_equals_cpu(dev):
    """Three bursts with gaps and a CFO: the receiver over a stream on the
    card finds the CPU run's payloads, flags and starts."""
    from srcdsp_tpu_torch.chains import css

    p = css.make_css_params(sf=7, cr=3)
    rng = np.random.default_rng(4)
    pls = [bytes(rng.integers(0, 256, 12, dtype=np.uint8)) for _ in range(3)]
    parts = []
    for i, q in enumerate(pls):
        parts += [np.zeros(90 + 53 * i, np.complex64), css.css_transmit(p, q)]
    x = np.concatenate(parts + [np.zeros(300, np.complex64)])
    x = (x * np.exp(2j * np.pi * 0.37 / p.n * np.arange(x.size))).astype(np.complex64)
    got = css.css_receive_stream(p, torch.as_tensor(x, device=dev), 12)
    assert got == css.css_receive_stream(p, x, 12, device="cpu")
    assert [g[0] for g in got] == pls


def _plane_tier_cases():
    """name -> fn(device) -> (exact tensors, soft tensors, soft tolerance)."""
    from srcdsp_tpu_torch.chains import (analog, blindscan, dqpsk, dsss, equalizer, fhss,
                                         framesync, mlse, msk)
    from srcdsp_tpu_torch.testing.signals import gmsk_baseband

    rng = np.random.default_rng(5)
    qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, 2048))).astype(np.complex64)
    isi = (np.convolve(qpsk, [1.0, 0.4 - 0.2j, -0.2j])[:2048]
           + 0.02 * (rng.standard_normal(2048) + 1j * rng.standard_normal(2048))
           ).astype(np.complex64)
    pre = np.exp(2j * np.pi * (rng.integers(0, 4, 64) + 0.5) / 4).astype(np.complex64)
    scene = (0.3 * (rng.standard_normal((2, 8192)) + 1j * rng.standard_normal((2, 8192)))
             ).astype(np.complex64)
    scene[:, 700:764] += pre
    gm = gmsk_baseband(rng.integers(0, 2, (2, 512)), 8)
    dib = rng.integers(0, 4, (2, 256))
    dq = (dqpsk.dqpsk_baseband(dib, 32) * np.exp(2j * np.pi * 0.11 * np.arange(8192 + 256))
          ).astype(np.complex64)[:, :8192]
    bpsk = 1.0 - 2.0 * rng.integers(0, 2, 64).astype(np.float32)
    k = np.arange(8192)
    fm_iq = analog.fm_modulate(torch.as_tensor(np.sin(2 * np.pi * 0.004 * k)
                                               [None].repeat(2, 0).astype(np.float32)), 0.02)
    mpx = np.stack([analog.fm_stereo_mpx(0.5 * np.cos(2 * np.pi * f * k),
                                         0.5 * np.cos(2 * np.pi * 0.0023 * k), 0.02)
                    for f in (0.001, 0.0013)])
    stereo_iq = analog.fm_modulate(torch.as_tensor(mpx), 0.02)
    t = lambda a, d: torch.as_tensor(a, device=d)                      # noqa: E731

    def fs(d):
        par = framesync.make_frame_sync_params(pre, device=d)
        _, (s, m, _) = framesync.frame_sync_apply(par, framesync.frame_sync_init(par, (2,)),
                                                   t(scene, d))
        return [m], [s], 1e-5

    def msk_(d):
        b, s = msk.msk_coherent_demod(t(gm, d), 8, msk.laurent_c0(8, c_span=4))
        return [b], [s], 1e-5

    def dq_(d):
        i, z = dqpsk.dqpsk_demod_stream(dqpsk.make_dqpsk_params(0.11, 4, 8, device=d), t(dq, d),
                                        2048, (2,))
        return [i], [z], 1e-5

    def ds(d):
        par = dsss.make_dsss_params(device=d)
        x = dsss.dsss_spread(par, t(bpsk, d))
        x = torch.roll(x, 17).to(torch.complex64)
        ph = dsss.dsss_acquire(par, x)
        b, s = dsss.dsss_rake_demod(par, x, ph, [0, 3])
        return [ph, b], [s], 1e-5

    def fh(d):
        par = fhss.make_fhss_params([-0.3, -0.1, 0.2, 0.35], [0, 2, 1, 3, 2], 128)
        y = fhss.fhss_hop(par, t(np.ones(4096, np.complex64), d), seq_phase=2)
        got = fhss.fhss_acquire(par, y[40:])
        return [torch.tensor(got)], [fhss.fhss_dehop(par, y, seq_phase=2)], 1e-5

    def ml(d):
        y = np.convolve(qpsk[:512], [1.0, 0.6j])[:512].astype(np.complex64)
        return [mlse.mlse_equalize(mlse.make_mlse([1.0, 0.6j], order=4), t(y, d))], [], 0

    def lms(d):
        st, y, m = equalizer.lms_equalize(t(isi, d), equalizer.eq_init(11, device=d), mu=0.1,
                                          d=t(qpsk, d))
        return [], [y, m, st.w], 1e-5

    def cma(d):
        st, y, m = equalizer.cma_equalize(t(isi, d), equalizer.eq_init(11, device=d), mu=0.05)
        return [], [y, m, st.w], 1e-5

    def rls(d):
        st, y, e = equalizer.rls_equalize(t(isi[:256], d), equalizer.rls_init(11, device=d),
                                          lam=0.995, d=t(qpsk[:256], d))
        return [], [y, st.w, st.p], 1e-5

    def dfe(d):
        st, y, e = equalizer.dfe_equalize(t(isi[:512], d), equalizer.dfe_init(9, 8, device=d),
                                          mu=0.02, d=t(qpsk[:512], d))
        return [], [y, st.ff, st.fb], 1e-5

    def rx(make, init, apply, x):
        def run(d):
            par = make(device=d)
            _, a = apply(par, init(par, tuple(x.shape[:-1])), x.to(d))
            return [], [a], 1e-5
        return run

    def scan(d):
        x = scene[0].copy()
        x += (0.5 * np.exp(2j * np.pi * 0.3 * np.arange(8192))).astype(np.complex64)
        return [torch.tensor([det.bandwidth for det in blindscan.scan(t(x, d), nfft=256)])], [], 0

    return {
        "framesync": fs, "msk": msk_, "dqpsk": dq_, "dsss": ds, "fhss": fh, "mlse": ml,
        "lms": lms, "cma": cma, "rls": rls, "dfe": dfe, "blindscan": scan,
        "fm": rx(lambda **k: analog.make_fm_params(0.0, 4, 0.08, audio_decim=2, deemph_tau=20.0,
                                                   **k), analog.fm_init, analog.fm_apply, fm_iq),
        "am": rx(lambda **k: analog.make_am_params(0.0, 4, audio_decim=2, **k), analog.am_init,
                 analog.am_apply, fm_iq),
        "ssb": rx(lambda **k: analog.make_ssb_params(0.01, 2, 0.04, **k), analog.ssb_init,
                  analog.ssb_apply, fm_iq),
        "fm_stereo_rx": rx(lambda **k: analog.make_fm_stereo_rx(0.0, 4, 0.08, 0.08,
                                                                deemph_tau=8.0, **k),
                           analog.fm_stereo_rx_init, analog.fm_stereo_rx_apply, stereo_iq),
    }


@pytest.mark.parametrize("name", sorted(_plane_tier_cases()))
def test_plane_tier_on_card_equals_cpu(dev, name):
    """Each chain of the plane tier at a small shape: its decisions (masks,
    bits, dibits, phases, MLSE symbols, detections) on the card equal the CPU
    run's; its soft outputs and states within rel L2 1e-5 (the RLS and DFE
    recursions too: phase 17 measured 2e-7)."""
    fn = _plane_tier_cases()[name]
    ex_d, soft_d, tol = fn(dev)
    ex_c, soft_c, _ = fn(torch.device("cpu"))
    for a, b in zip(ex_d, ex_c):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(soft_d, soft_c):
        assert float(torch.linalg.norm(a.cpu() - b) / torch.linalg.norm(b)) <= tol


def _ops_tier_cases():
    """name -> fn(device) -> (exact tensors, soft tensors, soft tolerance):
    the ops tier at small shapes (numpy inputs made once)."""
    from srcdsp_tpu_torch import array, mimo
    from srcdsp_tpu_torch.chains.qam import qam_constellation
    from srcdsp_tpu_torch.ops import accel, cfar, cyclo, dpd, fresh, fresh_planes, impairments
    from srcdsp_tpu_torch.ops import radar
    from srcdsp_tpu_torch.testing.signals import chirp

    rng = np.random.default_rng(6)
    cn = lambda *s: (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)  # noqa: E731
    t = lambda a, d: torch.as_tensor(a, device=d)                      # noqa: E731
    power = (0.5 * np.abs(cn(4, 4096)) ** 2).astype(np.float32)
    power[1, 900] += 60.0
    ref = chirp(64, -0.2, 0.2)
    cube = 0.1 * cn(32, 512)
    for k in range(32):
        cube[k, 137:201] += ref * np.exp(2j * np.pi * 5 * k / 32)
    iq = cn(2, 8192)
    iq[0] += 0.05
    bpsk = np.repeat(1.0 - 2.0 * rng.integers(0, 2, 1024), 8).astype(np.complex64)
    drift = np.exp(2j * np.pi * (0.1 * np.arange(4096) + 0.5 * 20 / 4096 ** 2 *
                                 np.arange(4096) ** 2)).astype(np.complex64)
    drive = (0.3 * cn(8192)).astype(np.complex64)
    pa = np.array([1.0, 0.05j, -0.08, 0.02, 0.01, 0.0], np.complex64)
    a_sig = (np.repeat(1.0 - 2.0 * rng.integers(0, 2, 1100), 8)[:8192]
             * np.exp(2j * np.pi * 0.02 * np.arange(8192))).astype(np.complex64)
    mix = (a_sig + np.repeat(1.0 - 2.0 * rng.integers(0, 2, 1700), 5)[:8192]
           * np.exp(2j * np.pi * 0.035 * np.arange(8192)) + 0.03 * cn(8192)).astype(np.complex64)
    br = fresh.merge_branches(fresh.bpsk_branches(0.02, 1 / 8), fresh.bpsk_branches(0.035, 0.2))
    steer_in = np.linspace(-1.2, 1.2, 241)
    snaps = cn(8, 4096)
    pts = qam_constellation(16)
    idx = rng.integers(0, 16, (2, 4096))
    h = (rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))).astype(np.complex64)
    y = (h @ pts[idx] + 0.05 * cn(2, 4096)).astype(np.complex64)
    lat = mimo.make_ml_lattice(pts, 2)

    def cf(d):
        m1, t1 = cfar.ca_cfar(t(power, d), guard=2, train=16, pfa=1e-3)
        m2, t2 = cfar.go_cfar_split(t(power, d), guard=2, train=16, pfa=1e-3)
        return [m1, m2], [t1, t2], 1e-5

    def rd(d):
        m = radar.range_doppler(t(cube, d), ref)
        pw = (m.real ** 2 + m.imag ** 2).contiguous()
        mask, thr = radar.cfar_2d(pw, guard=2, train=4, pfa=1e-6)
        return [mask], [m, thr], 1e-5

    def imp(d):
        g, phi = impairments.iq_imbalance_estimate(t(iq, d))
        st = impairments.moments_init((2,), device=d)
        for blk in t(iq, d).chunk(4, dim=-1):
            st = impairments.moments_update(st, blk)
        fixed = impairments.iq_imbalance_correct(t(iq, d), g, phi)
        c, mask = impairments.blank_impulses(t(iq, d), guard=2, train=32)
        est = torch.stack([g, phi, impairments.dc_offset(st).abs(), impairments.cfo_kay(t(iq, d)),
                           impairments.cfo_fft_peak(t(iq, d)), impairments.snr_m2m4(st)])
        return [mask], [est, fixed, c], 1e-5

    def cy(d):
        r = cyclo.fam_scf(t(bpsk, d), np_=64, p=128, conj=True)
        axis, prof = cyclo.cycle_profile(r)
        return [axis, torch.tensor(sorted(a for a, _ in cyclo.detect_cycles(r)))], [r.scf, prof], 1e-5

    def ac(d):
        res = accel.accel_search(t(drift, d), max_drift=30.0 / 4096 ** 2)
        rates = res.rates
        return ([accel.dechirp_phasors(rates, 4096, d),
                 torch.tensor(np.unravel_index(np.argmax(res.metric), res.metric.shape))],
                [torch.as_tensor(res.metric)], 1e-5)

    def dp(d):
        params, g = dpd.dpd_train_ila(lambda z: dpd.pa_memory_polynomial(pa, 3, 3, z),
                                      t(drive, d), 3, 3, iters=2)
        whole = dpd.dpd_full(params, t(drive, d))
        st, outs = dpd.dpd_init(params), []
        for blk in t(drive, d).tensor_split([100, 5000]):
            st, o = dpd.dpd_apply(params, st, blk)
            outs.append(o)
        assert torch.equal(torch.cat(outs), whole)
        return [], [whole], 1e-3

    def fr(d):
        f = fresh.fresh_design(t(mix[:4096], d), t(a_sig[:4096], d), br, taps=16)
        yy = fresh.fresh_apply(f, t(mix[4096:], d), n0=4096)
        fn = fresh_planes.make_fresh_planes(f, stride=128, device=d)
        seg = mix[4096: 4096 + 2048 + fn.hist]
        pr, pi = fn(t(seg.real[None].copy(), d), t(seg.imag[None].copy(), d), 4096)
        return [], [yy, pr, pi], 1e-3

    def ar(d):
        r = array.sample_covariance(t(snaps, d), loading=1e-3)
        steer = array.ula_steering(8, 0.5, steer_in, device=d)
        return [], [r, array.bartlett_spectrum(r, steer), array.mvdr_spectrum(r, steer),
                    array.music_spectrum(r, steer, 2),
                    array.beamform(array.mvdr_weights(r, steer[100]), t(snaps, d))], 1e-4

    def mi(d):
        return ([mimo.ml_detect(h, t(y, d), *lat)],
                [mimo.zf_detect(h, t(y, d)), mimo.mmse_detect(h, t(y, d), 100.0)], 1e-5)

    return {"cfar": cf, "radar": rd, "impairments": imp, "cyclo": cy, "accel": ac, "dpd": dp,
            "fresh": fr, "array": ar, "mimo": mi}


@pytest.mark.parametrize("name", sorted(_ops_tier_cases()))
def test_ops_tier_on_card_equals_cpu(dev, name):
    """Each module of the ops tier at a small shape: its decisions (CFAR
    masks, the blanker's mask, the cycle list, the accel phasors and peak
    cell, ML indices) on the card equal the CPU run's; its soft outputs
    within rel L2 1e-5 (1e-4 for the covariance's solves and eigh; 1e-3 for
    the outputs of the DPD and FRESH fits, solves of ill-conditioned or
    rank-deficient normal equations whose coefficients are not compared);
    the DPD blocks equal the one-shot run on the card (`torch.equal`)."""
    fn = _ops_tier_cases()[name]
    ex_d, soft_d, tol = fn(dev)
    ex_c, soft_c, _ = fn(torch.device("cpu"))
    for a, b in zip(ex_d, ex_c):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(soft_d, soft_c):
        assert float(torch.linalg.norm(a.cpu() - b) / torch.linalg.norm(b)) <= tol


def test_ops_tier_matmuls_with_tf32_allowed(dev):
    """With TF32 allowed globally, the tier's products stay float32 (each
    pins TF32 off): the DPD fit (coefficients within 2e-2, the float32
    spread of its ill-conditioned Gram), the FRESH design's output and
    planes (1e-3), the covariance (1e-5) and the ML indices (equal) match
    the CPU's."""
    from srcdsp_tpu_torch import array, mimo
    from srcdsp_tpu_torch.chains.qam import qam_constellation
    from srcdsp_tpu_torch.ops import dpd, fresh, fresh_planes

    rng = np.random.default_rng(7)
    cn = lambda *s: (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)  # noqa: E731
    x = 0.3 * cn(8192)
    snaps = cn(8, 8192)
    pts = qam_constellation(16)
    idx = rng.integers(0, 16, (2, 8192))
    h = cn(2, 2)
    y = (h @ pts[idx] + 0.01 * cn(2, 8192)).astype(np.complex64)
    br = fresh.bpsk_branches(0.05, 0.125)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        out = {}
        for d in (dev, torch.device("cpu")):
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            pa_out = dpd.pa_saleh(torch.as_tensor(x, device=d))
            c = dpd.dpd_identify_ila(torch.as_tensor(x, device=d), pa_out, 5, 2, 1.0)
            torch.backends.cuda.matmul.allow_tf32 = True
            f = fresh.fresh_design(torch.as_tensor(x, device=d), torch.as_tensor(x, device=d), br,
                                   taps=8)
            torch.backends.cuda.matmul.allow_tf32 = True
            fy = fresh.fresh_apply(f, torch.as_tensor(x, device=d))
            torch.backends.cuda.matmul.allow_tf32 = True
            fn = fresh_planes.make_fresh_planes(f, device=d)
            seg = torch.as_tensor(x[: 4096 + fn.hist], device=d)
            pr, _ = fn(seg.real[None].contiguous(), seg.imag[None].contiguous(), 0)
            torch.backends.cuda.matmul.allow_tf32 = True
            r = array.sample_covariance(torch.as_tensor(snaps, device=d))
            torch.backends.cuda.matmul.allow_tf32 = True
            ml = mimo.ml_detect(h, torch.as_tensor(y, device=d), *mimo.make_ml_lattice(pts, 2))
            out[d.type] = (c, fy, pr, r, ml)
        c, w, pr, r, ml = out["cuda"]
        cc, wc, prc, rc, mlc = out["cpu"]
        rel = lambda a, b: float(torch.linalg.norm(a.cpu() - b) / torch.linalg.norm(b))  # noqa: E731
        assert rel(c, cc) <= 2e-2 and rel(w, wc) <= 1e-3 and rel(pr, prc) <= 1e-3
        assert rel(r, rc) <= 1e-5
        assert torch.equal(ml.cpu(), mlc) and torch.equal(mlc, torch.as_tensor(idx, dtype=torch.int32))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def test_linear_tx_takes_the_receivers_card_taps(dev):
    """make_linear_tx accepts a receiver's taps as they lie on the card (the
    array link's composition: the PSK receiver's RRC shapes the transmitter)
    and transmits what the CPU-built transmitter does."""
    from srcdsp_tpu_torch.chains import psk, tx

    rxp = psk.make_psk_params(0.12, decim=2, sps=4, order=4, device=dev)
    sym = tx.psk_map(torch.arange(64, device=dev) % 4, 4)
    out = {}
    for taps, d in ((rxp.taps, dev), (rxp.taps.cpu().numpy(), "cpu")):
        p = tx.make_linear_tx(0.12, taps, sps=8, device=d)
        out[d if d == "cpu" else "card"] = tx.linear_tx_apply(p, tx.linear_tx_init(p), sym.to(d))[1]
    assert float(torch.linalg.norm(out["card"].cpu() - out["cpu"])
                 / torch.linalg.norm(out["cpu"])) <= 1e-5


def test_cli_fecdec_ldpc_on_card_equals_cpu(dev, tmp_path):
    """`fecdec --code ldpc` on the card runs K14 (its launch count rises) and
    writes the same bytes as the `--device cpu` run (the plain K14)."""
    from srcdsp_tpu_torch.cli import main as cli_main

    rng = np.random.default_rng(4)
    u = rng.integers(0, 2, 252 * 64).astype(np.uint8)
    u.tofile(tmp_path / "u.u8")
    cli_main(["fecenc", str(tmp_path / "u.u8"), str(tmp_path / "c.u8"), "--device", "cpu"])
    c = np.fromfile(tmp_path / "c.u8", np.uint8)
    llr = (2.0 * (1.0 - 2.0 * c) + 0.8 * rng.standard_normal(c.size)).astype(np.float32)
    llr.tofile(tmp_path / "llr.f32")
    before = _build.LAUNCHES["ldpc_edges"]
    for tag, d in (("card", "cuda"), ("cpu", "cpu")):
        cli_main(["fecdec", str(tmp_path / "llr.f32"), str(tmp_path / f"{tag}.u8"),
                  "--device", d])
    assert _build.LAUNCHES["ldpc_edges"] > before
    card = np.fromfile(tmp_path / "card.u8", np.uint8)
    assert np.array_equal(card, np.fromfile(tmp_path / "cpu.u8", np.uint8))
    assert np.array_equal(card, u)


def test_checkpoint_restore_onto_a_card_example(dev, tmp_path):
    """A state saved from the CPU restores onto card tensors (each leaf on its
    example's device) and back to the CPU bit for bit."""
    from srcdsp_tpu_torch import checkpoint, tree
    from srcdsp_tpu_torch.chains.fsk import fsk_apply, fsk_init, make_fsk_params

    params = make_fsk_params(0.11, 64, 0.1, 4, 8, 0.05, device="cpu")
    x = torch.as_tensor((np.random.default_rng(5).standard_normal(4096)
                         + 1j * np.random.default_rng(6).standard_normal(4096)
                         ).astype(np.complex64))
    st, _ = fsk_apply(params, fsk_init(params), x)
    checkpoint.save(str(tmp_path / "ck"), st, 1)
    on_card, blk = checkpoint.restore(str(tmp_path / "ck"), fsk_init(
        make_fsk_params(0.11, 64, 0.1, 4, 8, 0.05, device=dev)))
    assert blk == 1
    for a, b in zip(tree.flatten(st)[0], tree.flatten(on_card)[0]):
        assert b.device.type == "cuda" and torch.equal(a, b.cpu())
    checkpoint.save(str(tmp_path / "ck2"), on_card, 2)
    back, _ = checkpoint.restore(str(tmp_path / "ck2"), st)
    for a, b in zip(tree.flatten(st)[0], tree.flatten(back)[0]):
        assert b.device.type == "cpu" and torch.equal(a, b)


def test_checked_raises_on_the_card(dev):
    from srcdsp_tpu_torch.chains.fsk import fsk_apply, fsk_init, make_fsk_params
    from srcdsp_tpu_torch.debug import NonFiniteError, checked

    params = make_fsk_params(0.11, 64, 0.1, 4, 8, 0.05, device=dev)
    step = checked(lambda s, x: fsk_apply(params, s, x))
    x = torch.ones(4096, dtype=torch.complex64, device=dev)
    step(fsk_init(params), x)
    x[100] = float("nan")
    with pytest.raises(NonFiniteError, match=r"\[0\]\.timing\.acc"):
        step(fsk_init(params), x)
    step(fsk_init(params), torch.ones(4096, dtype=torch.complex64, device=dev))   # still usable


def _ranks_init(tmp_path, device: str, timeout: float = 60.0):
    """Start two fresh processes that call init_multihost(..., "nccl",
    device=device); return their exit codes and outputs."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    code = ("import sys, torch\n"
            "from srcdsp_tpu_torch.dist.mesh import init_multihost\n"
            "try:\n"
            f"    init_multihost('file://{tmp_path}/rdv', 2, int(sys.argv[1]), 'nccl', "
            f"device='{device}', timeout=60)\n"
            "except ValueError as e:\n"
            "    print('REFUSED', e)\n"
            "    sys.exit(3)\n"
            "torch.distributed.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root,
                                                                   os.environ.get("PYTHONPATH")])))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=root)
             for r in range(2)]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    return [p.returncode for p in procs], outs


def test_nccl_refuses_two_ranks_on_one_card(dev, tmp_path):
    """NCCL needs one card a rank: two ranks that name cuda:0 both raise in
    init_multihost, before any NCCL communicator opens (no switch to gloo)."""
    codes, outs = _ranks_init(tmp_path, "cuda:0")
    assert codes == [3, 3], outs
    assert all("one card per rank" in o for o in outs), outs


def test_multihost_check_on_one_card_over_gloo(dev, tmp_path):
    """The pipeline, K1 and K11 across 2 ranks that share the card (gloo,
    card tensors staged through the host and counted): each equal to its
    one-process form, the kernels launched by the workers."""
    from srcdsp_tpu_torch.dist import multihost_check as mhc

    res = mhc.run(2, "cuda", "gloo", shards=2, cases=("pipeline", "k1", "k11"),
                  work=tmp_path, timeout=300)
    assert res["ok"], res["error"]
    for rep in res["reports"]:
        assert all(c["ok"] for c in rep["cases"].values())
        assert rep["cases"]["pipeline"]["staged"]["bytes"] > 0
        assert rep["cases"]["k1"]["launches"].get("mixfir", 0) == 2
        assert rep["cases"]["k11"]["launches"].get("fftconv", 0) == 2


def test_multihost_check_one_card_a_rank_over_nccl(dev, tmp_path):
    """The same across 2 cards, one a rank, over NCCL: nothing staged."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    from srcdsp_tpu_torch.dist import multihost_check as mhc

    res = mhc.run(2, "cuda", "nccl", shards=2, cases=("pipeline", "k1", "k11"),
                  work=tmp_path, timeout=300)
    assert res["ok"], res["error"]
    for rep in res["reports"]:
        assert all(c["ok"] for c in rep["cases"].values())
        assert all(c["staged"]["bytes"] == 0 for c in rep["cases"].values())


def _halo_ranks_hold(res):
    """K19 and K20 across ranks: every case equal to its one-process form, no
    byte staged in the step without the gather, K19 launched in both cases
    (K20's boundary and tail are K19 pushes) and K20 once a shard."""
    assert res["ok"], res["error"]
    for rep in res["reports"]:
        k19, k20 = rep["cases"]["k19"], rep["cases"]["k20"]
        assert k19["ok"] and k20["ok"]
        for c in k19["shapes"] + [k20]:
            assert c["staged"]["bytes"] == 0, c["staged"]
        assert all(c["launches"].get("halo_dma", 0) == 1 for c in k19["shapes"])
        assert k20["launches"].get("halo_dma", 0) == 1
        assert k20["launches"].get("halo_fused", 0) == 2
    r0 = res["reports"][0]["cases"]
    assert all(c["equal_one_process"] and c["equal_slices"] for c in r0["k19"]["shapes"])
    assert r0["k20"]["equal_one_process"] and r0["k20"]["equal_one_call"]


def test_halo_kernels_across_two_ranks_on_one_card_over_ipc(dev, tmp_path):
    """K19 and K20 across 2 ranks that share the card (gloo for the group,
    the boundary and the carried tail by CUDA IPC): equal to the one-process
    forms, nothing staged through the host in the halo step."""
    from srcdsp_tpu_torch.dist import multihost_check as mhc

    _halo_ranks_hold(mhc.run(2, "cuda", "gloo", shards=2, cases=("k19", "k20"), work=tmp_path,
                             timeout=300))


def test_halo_kernels_one_card_a_rank_over_nccl_and_ipc(dev, tmp_path):
    """The same across 2 cards, one a rank, over NCCL: the push crosses
    NVLink into the other process's buffer."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    from srcdsp_tpu_torch.dist import multihost_check as mhc

    _halo_ranks_hold(mhc.run(2, "cuda", "nccl", shards=2, cases=("k19", "k20"), work=tmp_path,
                             timeout=300))


@pytest.mark.parametrize("cards", [1, 2])
def test_capture_streamed_onto_a_card_mesh_equals_the_k1_stream(dev, tmp_path, cards):
    """A ci16 capture onto 4 shards of one card (or one shard a card on two):
    one host copy a shard a block into a buffer of its own, K20 over the
    shards block after block == K1 on [tail | block] by torch.equal."""
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    from srcdsp_tpu_torch.dist import mesh as dmesh
    from srcdsp_tpu_torch.dist import multihost_check as mhc
    from srcdsp_tpu_torch.io import capture
    from srcdsp_tpu_torch.kernels import halo_fused as khf

    card = torch.device("cuda", 0)
    mesh = (dmesh.make_mesh(time=4, devices=[card] * 4) if cards == 1
            else dmesh.make_mesh(time=2))
    devs = mesh.axis_devices()
    taps, word = lowpass(64, 0.2), int(freq_to_word(0.11))
    ks = dmesh.per_device(lambda d: khf.make_halo_fused_kernel(taps, 2, out_tile=128, b_rows=2,
                                                               device=d), devs)
    k1 = kmf.make_mix_fir_kernel(taps, 2, out_tile=128, b_rows=2, device=card)
    block, blocks, hist = 4 * 4 * ks[0].block_in(), 3, k1.hist
    path = tmp_path / "x.ci16"
    mhc.write_noise_capture(path, blocks * block, seed=7)
    capture.reset_h2d()
    for shards in capture.device_blocks(str(path), block, planes=True,
                                        sharding=dmesh.time_sharding(mesh, 2)):
        assert tuple(s.device for s in shards) == devs
        assert all(s.untyped_storage().nbytes() == s.numel() * 4 for s in shards)
    for d in set(devs):
        k = devs.count(d)
        assert capture.H2D[str(d)] == {"copies": blocks * k,
                                       "bytes": blocks * k * block * 8 // len(devs)}
    tail, ys = mhc.stream_k20(ks, word, path, block, mesh)
    ktail = torch.zeros((2, hist), device=card)
    for b, xb in enumerate(capture.device_blocks(str(path), block, planes=True, device=card)):
        yr, yi = k1.fn((b * block * word - hist * word) & 0xFFFFFFFF, word,
                       torch.cat([ktail, xb], dim=-1))
        got = torch.cat([y.to(card) for y in ys[b]], dim=-1)
        assert torch.equal(got, torch.stack([yr.reshape(-1), yi.reshape(-1)]))
        ktail = xb[:, -hist:]
    assert torch.equal(tail.to(card), ktail)


def test_capture_streamed_across_two_ranks_on_one_card(dev, tmp_path):
    """The multihost capture case on the card: each rank streams its own
    shards of one file through K20 over IPC, == the one-process stream."""
    from srcdsp_tpu_torch.dist import multihost_check as mhc

    res = mhc.run(2, "cuda", "gloo", shards=2, cases=("capture",), work=tmp_path, timeout=300)
    assert res["ok"], res["error"]
    caps = [rep["cases"]["capture"] for rep in res["reports"]]
    assert all(c["ok"] for c in caps) and caps[0]["equal_one_process"]
    assert sum(c["launches"].get("halo_fused", 0) for c in caps) == 2 * 2 * caps[0]["blocks"]
    assert caps[0]["launches"].get("halo_dma", 0) > 0


def test_ipc_open_of_a_handle_this_process_exported_raises(dev):
    """A handle opens only in another process: opening this process's own
    export raises, naming the CUDA error; the export itself frees cleanly."""
    from srcdsp_tpu_torch.dist import ipc

    card = torch.device("cuda", 0)
    ptr, handle = ipc.export(4096, card)
    try:
        assert ptr and len(handle) == ipc.HANDLE_BYTES
        with pytest.raises(RuntimeError, match=r"cudaIpcOpenMemHandle .*: cudaError\w+ \("):
            ipc.open_handle(handle, card, owner=0)
    finally:
        ipc.free(ptr, card)
