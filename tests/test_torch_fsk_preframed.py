"""Port vs JAX package: kernel K7 (fsk_preframed) and K3's bf16 ingest.

The plain PyTorch versions (what the wrappers run on a CPU tensor) are held
against the Pallas kernels in interpret mode (out_tile=128, b_rows=2) on the
same FSK planes. Contracts:

- f32: soft symbols and d atol 1e-4, bits equal, O&M sums rtol 1e-4 /
  atol 1e-3 (K3's, tests/test_torch_fsk_kernels.py: atan2f against the TPU
  polynomial, float32 sums in another order);
- bf16 ingest: bits equal and soft symbols atol 5e-2, the reference's own
  contract for its bf16 variant (tests/unit/test_fsk_ctaps.py); the port
  keeps f32 taps where the JAX variant rounds them to bf16;
- bit-exact inside the port: K7 against K3 on the same stream, in each dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.kernels import fsk_ctaps as jct
from srcdsp_tpu.kernels import fsk_preframed as jfp
from srcdsp_tpu.kernels.mixfir_preframed import frame_planes as jframe_planes
from srcdsp_tpu.ops.nco import freq_to_word
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu.testing.signals import fsk_baseband, random_bits, tone
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels import fsk_ctaps as tct
from srcdsp_tpu_torch.kernels import fsk_preframed as tfp
from srcdsp_tpu_torch.kernels import mixfir_preframed as tpf
from tests.torch_threads import one_torch_thread  # noqa: F401

NCH, DECIM, SPS, OT, BR = 2, 4, 8, 128, 2
BF16 = torch.bfloat16


def _fixture(nsym=512):
    centers = [0.11 + 0.01 * c for c in range(NCH)]
    bits = random_bits(jax.random.PRNGKey(0), (NCH, nsym))
    bb = fsk_baseband(bits, DECIM * SPS, 0.05 / DECIM)
    x = np.asarray(bb) * np.stack([np.asarray(tone(bb.shape[-1], c)) for c in centers])
    words = np.asarray([freq_to_word(-c) for c in centers], np.uint32)
    hist = 128
    blk = BR * OT * DECIM
    x = x[:, :(x.shape[-1] // blk) * blk]
    xpad = np.concatenate([np.zeros((NCH, hist), np.complex64), x], axis=1)
    planes = np.stack([xpad.real, xpad.imag], axis=1).astype(np.float32)
    return words, planes, hist


def _assert_f32_contract(jout, tout, jd, td, jst, tst):
    """soft and d atol 1e-4, bits equal, st rtol 1e-4 / atol 1e-3."""
    (_, (jbits, jsoft)), (_, (tbits, tsoft)) = jout, tout
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(tsoft.numpy(), np.asarray(jsoft), atol=1e-4)
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=1e-4, atol=1e-3)


def _assert_bf16_contract(jout, tout):
    """bits equal, soft atol 5e-2 (tests/unit/test_fsk_ctaps.py, bf16 ingest)."""
    (_, (jbits, jsoft)), (_, (tbits, tsoft)) = jout, tout
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    np.testing.assert_allclose(tsoft.numpy(), np.asarray(jsoft), atol=5e-2)


def _frames(planes, stride, span, dtype=torch.float32):
    fr = tpf.frame_planes(torch.from_numpy(planes).to(dtype), stride, span)
    return fr[:, 0].contiguous(), fr[:, 1].contiguous()


@pytest.mark.parametrize("class_major", [False, True])
def test_fsk_preframed_plain_matches_pallas_interpret(class_major):
    words, planes, hist = _fixture()
    taps = lowpass(64, 0.03)
    jfn, jhist, stride, span = jfp.make_fsk_preframed_kernel(
        taps, words, DECIM, SPS, out_tile=OT, b_rows=BR, class_major=class_major,
        interpret=True)
    tfn, thist, tstride, tspan = tfp.make_fsk_preframed_kernel(
        taps, words, DECIM, SPS, out_tile=OT, b_rows=BR, class_major=class_major, device="cpu")
    assert (jhist, stride, span) == (thist, tstride, tspan) == (hist, OT * DECIM,
                                                                OT * DECIM + hist)
    jfr = jframe_planes(jnp.asarray(planes), stride, span)
    xr_f, xi_f = _frames(planes, stride, span)
    np.testing.assert_array_equal(xr_f.numpy(), np.asarray(jfr[:, 0]))
    jout = jfp.fsk_demod_preframed(jfn, OT, jfr[:, 0], jfr[:, 1], SPS,
                                   class_major=class_major)
    tout = tfp.fsk_demod_preframed(tfn, OT, xr_f, xi_f, SPS, class_major=class_major)
    jd, jst = jfn(jfr[:, 0], jfr[:, 1])
    td, tst = tfn(xr_f, xi_f)
    _assert_f32_contract(jout, tout, jd, td, jst, tst)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_fsk_preframed_plain_equals_ctaps_plain_bit_exact(dtype):
    """K7 gives K3's d, st and bits on the same stream, and carries the demod
    state across chunks alike."""
    words, planes, hist = _fixture(nsym=1024)
    taps = lowpass(64, 0.03)
    fn3, _ = tct.make_fsk_ctaps_kernel(taps, words, DECIM, SPS, out_tile=OT, b_rows=BR,
                                       class_major=True, in_dtype=dtype, device="cpu")
    fn7, _, stride, span = tfp.make_fsk_preframed_kernel(
        taps, words, DECIM, SPS, out_tile=OT, b_rows=BR, class_major=True, in_dtype=dtype,
        device="cpu")
    n = planes.shape[-1] - hist
    s3 = s7 = None
    for lo in (0, n // 2):
        chunk = torch.from_numpy(planes[:, :, lo:lo + hist + n // 2]).to(dtype).contiguous()
        xr_f, xi_f = _frames(chunk.float().numpy(), stride, span, dtype)
        d3, st3 = fn3(chunk)
        d7, st7 = fn7(xr_f, xi_f)
        assert torch.equal(d3, d7) and torch.equal(st3, st7)
        s3, (b3, soft3) = tct.fsk_demod_ctaps(fn3, hist, OT, chunk, SPS, s3, True)
        s7, (b7, soft7) = tfp.fsk_demod_preframed(fn7, OT, xr_f, xi_f, SPS, s7, True)
        assert torch.equal(b3, b7) and torch.equal(soft3, soft7)
        assert all(torch.equal(a, b) for a, b in zip(s3, s7))


def test_fsk_ctaps_bf16_matches_jax_bf16_and_f32():
    words, planes, hist = _fixture()
    taps = lowpass(64, 0.03)
    tfn, _ = tct.make_fsk_ctaps_kernel(taps, words, DECIM, SPS, out_tile=OT, b_rows=BR,
                                       class_major=True, in_dtype=BF16, device="cpu")
    xb = torch.from_numpy(planes).to(BF16)
    tout = tct.fsk_demod_ctaps(tfn, hist, OT, xb, SPS, class_major=True)
    assert tout[1][1].dtype == torch.float32
    for jdt, prec in ((jnp.bfloat16, jax.lax.Precision.DEFAULT),
                      (jnp.float32, jax.lax.Precision.HIGHEST)):
        jfn, _ = jct.make_fsk_ctaps_kernel(taps, words, DECIM, SPS, out_tile=OT, b_rows=BR,
                                           precision=prec, class_major=True, in_dtype=jdt,
                                           interpret=True)
        jout = jct.fsk_demod_ctaps(jfn, hist, OT, jnp.asarray(planes).astype(jdt), SPS,
                                   class_major=True)
        _assert_bf16_contract(jout, tout)


def test_fsk_bf16_ingest_wrappers_reject_other_dtype():
    words, planes, hist = _fixture(nsym=256)
    taps = lowpass(64, 0.03)
    fn3, _ = tct.make_fsk_ctaps_kernel(taps, words, DECIM, SPS, out_tile=OT, b_rows=BR,
                                       in_dtype=BF16, device="cpu")
    fn7, _, stride, span = tfp.make_fsk_preframed_kernel(taps, words, DECIM, SPS,
                                                         out_tile=OT, b_rows=BR, device="cpu")
    with pytest.raises(ValueError, match="in_dtype"):
        fn3(torch.from_numpy(planes))
    with pytest.raises(ValueError, match="in_dtype"):
        fn7(*_frames(planes, stride, span, BF16))
    xr_f, xi_f = _frames(planes, stride, span)
    with pytest.raises(ValueError, match="frames"):
        fn7(xr_f[:1].contiguous(), xi_f[:1].contiguous())
    _build.reset_launches()
    d, st = fn7(xr_f, xi_f)
    assert d.device.type == "cpu" and all(v == 0 for v in _build.LAUNCHES.values())
