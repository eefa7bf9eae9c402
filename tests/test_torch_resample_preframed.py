"""Port vs JAX package: kernel K9 (the pre-framed mix + L/M resampler).

On a CPU tensor the port's K9 runs its plain version (the stream rebuilt from
the frames, then K8's plain version); it is held against the Pallas kernel in
interpret mode (out_tile=192, b_rows=2, block_cols=48, the JAX CPU A/B's
geometry at the config-2 combined taps). Contracts:

- `banded_resample_ctaps`: bit-equal to the JAX function;
- against the JAX kernel: SNR > 100 dB, the reference's own bar between its
  pre-framed and fused resamplers (the JAX kernel folds the NCO into complex
  bands, the port mixes each staged sample);
- bit-exact: K9's plain version against K8's on the same stream, and chunked
  calls (frames split at a row block, word0 advanced) against one call;
- bf16 frames: SNR > 40 dB against the port's f32 output (the reference's
  gate, bench/ab_resample_preframed.py:119), and > 40 dB against the JAX bf16
  variant, which also rounds its bands to bf16 (the same gate: the two differ
  by that rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.kernels import mixfir_preframed as jpf
from srcdsp_tpu.kernels import resample_pallas as jrp
from srcdsp_tpu.kernels import resample_preframed as jrf
from srcdsp_tpu.ops.nco import freq_to_word
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels import mixfir_preframed as tpf
from srcdsp_tpu_torch.kernels import resample_pallas as trp
from srcdsp_tpu_torch.kernels import resample_preframed as trf

OT, BR, BC = 192, 2, 48
BF16 = torch.bfloat16
WORD = int(freq_to_word(0.07))


def _snr_db(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2) / np.mean(np.abs(got - ref) ** 2)))


def _cplx(yr, yi):
    return np.asarray(yr, np.float64).ravel() + 1j * np.asarray(yi, np.float64).ravel()


def _hc():
    return trp.combine_fir_resample_taps(lowpass(128, 0.2), lowpass(48, 0.3), 3)


def _planes(hist, n, seed=0):
    x = np.random.default_rng(seed).standard_normal((2, hist + n)).astype(np.float32)
    x[:, :hist] = 0.0
    return x


def _w0(word0):
    return jnp.asarray(np.asarray([[word0]], np.uint32).view(np.int32))


@pytest.mark.parametrize("out_tile,block_cols,up,down", [(192, 48, 3, 4), (96, 48, 3, 4),
                                                         (128, 64, 1, 2), (128, 128, 2, 1)])
def test_banded_ctaps_bit_equal_to_jax(out_tile, block_cols, up, down):
    taps = lowpass(40, 0.2)
    hist = 128
    np.testing.assert_array_equal(
        trf.banded_resample_ctaps(taps, WORD, up, down, out_tile, hist, block_cols),
        jrf.banded_resample_ctaps(taps, WORD, up, down, out_tile, hist, block_cols))


def test_plain_matches_pallas_interpret():
    hc = _hc()
    jfn, jhist, jstride, jspan = jrf.make_resample_preframed_kernel(
        hc, WORD, 3, 4, out_tile=OT, b_rows=BR, block_cols=BC, interpret=True)
    tfn, hist, stride, span = trf.make_resample_preframed_kernel(
        hc, WORD, 3, 4, out_tile=OT, b_rows=BR, device="cpu")
    assert (hist, stride, span) == (jhist, jstride, jspan) == (256, 256, 512)
    x = _planes(hist, 3 * BR * stride)
    word0 = (-hist * WORD) % (1 << 32)
    jfr = jpf.frame_planes(jnp.asarray(x), stride, span)
    jr, ji = jfn(_w0(word0), jfr[0], jfr[1])
    fr = tpf.frame_planes(torch.from_numpy(x), stride, span)
    tr, ti = tfn(word0, fr[0], fr[1])
    assert tr.shape == jr.shape == (3 * BR, OT)
    assert _snr_db(_cplx(jr, ji), _cplx(tr, ti)) > 100.0


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_plain_equals_k8_plain_bit_exact(dtype):
    """K9 at out_tile 192 over frames == K8 at out_tile 384 over the planes:
    every output is the same sum whatever row it falls in."""
    hc = _hc()
    fn, hist, stride, span = trf.make_resample_preframed_kernel(
        hc, WORD, 3, 4, out_tile=OT, b_rows=BR, in_dtype=dtype, device="cpu")
    k8 = trp.make_mix_resample_kernel(hc, 3, 4, out_tile=384, b_rows=1, device="cpu")
    x = torch.from_numpy(_planes(hist, 4 * BR * stride, seed=1)).to(dtype)
    word0 = (-hist * WORD) % (1 << 32)
    fr = tpf.frame_planes(x, stride, span)
    yr, yi = fn(word0, fr[0], fr[1])
    r8, i8 = trp.mix_resample_plain(word0, WORD, x[None], torch.from_numpy(hc), 3, 4, 384,
                                    hist)
    assert torch.equal(yr.reshape(-1), r8.reshape(-1))
    assert torch.equal(yi.reshape(-1), i8.reshape(-1))


def test_chunked_bit_exact():
    fn, hist, stride, span = trf.make_resample_preframed_kernel(
        _hc(), WORD, 3, 4, out_tile=OT, b_rows=BR, device="cpu")
    x = torch.from_numpy(_planes(hist, 4 * BR * stride, seed=2))
    word0 = (-hist * WORD) % (1 << 32)
    fr = tpf.frame_planes(x, stride, span)
    yr, yi = fn(word0, fr[0], fr[1])
    cut = 2 * BR
    parts = [fn((word0 + lo * stride * WORD) % (1 << 32), fr[0, lo:hi].contiguous(),
                fr[1, lo:hi].contiguous()) for lo, hi in ((0, cut), (cut, fr.shape[1]))]
    assert torch.equal(torch.cat([p[0] for p in parts]), yr)
    assert torch.equal(torch.cat([p[1] for p in parts]), yi)


def test_bf16_frames_snr_against_f32_and_jax_bf16():
    hc = _hc()
    fb, hist, stride, span = trf.make_resample_preframed_kernel(
        hc, WORD, 3, 4, out_tile=OT, b_rows=BR, in_dtype=BF16, device="cpu")
    ff, *_ = trf.make_resample_preframed_kernel(hc, WORD, 3, 4, out_tile=OT, b_rows=BR,
                                                device="cpu")
    x = _planes(hist, 3 * BR * stride, seed=3)
    word0 = (-hist * WORD) % (1 << 32)
    fr = tpf.frame_planes(torch.from_numpy(x), stride, span)
    frb = tpf.frame_planes(torch.from_numpy(x).to(BF16), stride, span)
    br, bi = fb(word0, frb[0], frb[1])
    assert br.dtype == torch.float32
    got = _cplx(br, bi)
    assert _snr_db(_cplx(*ff(word0, fr[0], fr[1])), got) > 40.0
    jfn, *_ = jrf.make_resample_preframed_kernel(hc, WORD, 3, 4, out_tile=OT, b_rows=BR,
                                                 block_cols=BC, in_dtype=jnp.bfloat16,
                                                 interpret=True)
    jfr = jpf.frame_planes(jnp.asarray(x), stride, span).astype(jnp.bfloat16)
    jr, ji = jfn(_w0(word0), jfr[0], jfr[1])
    assert _snr_db(_cplx(jr, ji), got) > 40.0


def test_wrappers_reject_bad_frames_and_geometry():
    fn, hist, stride, span = trf.make_resample_preframed_kernel(
        _hc(), WORD, 3, 4, out_tile=OT, b_rows=BR, device="cpu")
    fr = tpf.frame_planes(torch.from_numpy(_planes(hist, 2 * BR * stride)), stride, span)
    _build.reset_launches()
    assert fn(0, fr[0], fr[1])[0].device.type == "cpu"
    assert all(v == 0 for v in _build.LAUNCHES.values())
    with pytest.raises(ValueError, match="in_dtype"):
        fn(0, fr[0].to(BF16), fr[1].to(BF16))
    with pytest.raises(ValueError, match="b_rows"):
        fn(0, fr[0, :-1].contiguous(), fr[1, :-1].contiguous())
    with pytest.raises(ValueError, match="hist \\| stride"):
        trf.make_resample_preframed_kernel(_hc(), WORD, 3, 4, out_tile=384 + 96, device="cpu")
    with pytest.raises(ValueError, match="in_dtype"):
        trf.make_resample_preframed_kernel(_hc(), WORD, 3, 4, out_tile=OT,
                                           in_dtype=torch.float16, device="cpu")
