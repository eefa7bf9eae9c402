"""Port vs JAX package: kernels K4 (mixfir_ctaps), K5 (ctaps_preframed) and
K6 (the frame kernel), and the config-1 serving presets (build_config1_serving).

On a CPU tensor the port's wrappers run their plain PyTorch versions; they are
held against the Pallas kernels in interpret mode (out_tile=128, b_rows=2) on
the same numpy planes. Contracts, each stated beside its helper:

- f32 against the Pallas kernel: atol 2e-5 * max|y|, the reference's own
  tolerance between its complex-taps and mix kernels;
- bf16 ingest: SNR > 30 dB against the f32 output, the reference's floor for
  its bf16 variant (the port keeps f32 taps, the JAX variant rounds them);
- bit-exact: chunked launches against one launch, K5 against K4 on the same
  stream, frames against the JAX frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.kernels import mixfir_ctaps as jct
from srcdsp_tpu.kernels import mixfir_preframed as jpf
from srcdsp_tpu.ops.nco import freq_to_word
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu_torch import configs as tconfigs
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels import mixfir_ctaps as tct
from srcdsp_tpu_torch.kernels import mixfir_preframed as tpf

OT, BR = 128, 2
BF16 = torch.bfloat16
DTYPES = [torch.float32, BF16]
JAX_DTYPE = {torch.float32: jnp.float32, BF16: jnp.bfloat16}


def _close_to_pallas(got, ref):
    """atol 2e-5 * max|y| (tests/unit/test_mixfir_ctaps.py, ctaps vs mixfir):
    float32 sums in another order and another phasor evaluation."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=2e-5 * float(np.max(np.abs(ref))))


def _snr_db(ref, got) -> float:
    """Signal-to-error ratio; the bf16-ingest floor is 30 dB
    (tests/unit/test_mixfir_ctaps.py, the reference's bf16 variant)."""
    ref, got = np.asarray(ref), np.asarray(got)
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2) / np.mean(np.abs(got - ref) ** 2)))


def _cplx(yr, yi):
    return np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)


def _fixture(t=64, m=2, blocks=3, seed=0, freq=0.11):
    taps = lowpass(t, 0.4 / max(m, 2))
    word = int(freq_to_word(freq))
    hist = 128
    n = blocks * BR * OT * m
    x = np.random.default_rng(seed).standard_normal((2, hist + n)).astype(np.float32)
    return taps, word, hist, n, x, (-hist * word) % (1 << 32)


def _port(x, dtype):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("t,m", [(64, 2), (33, 4)])
def test_ctaps_plain_matches_pallas_interpret(t, m):
    taps, word, hist, n, x, w0 = _fixture(t, m, freq=0.1743)
    jk = jct.make_mix_fir_ctaps_kernel(taps, word, m, out_tile=OT, b_rows=BR, interpret=True)
    tk = tct.make_mix_fir_ctaps_kernel(taps, word, m, out_tile=OT, b_rows=BR, device="cpu")
    assert (tk.hist, tk.block_in(), tk.dword) == (jk.hist, jk.block_in(), jk.dword)
    jr, ji = jct.mix_fir_ctaps_pallas(jk, w0, jnp.asarray(x))
    tr, ti = tct.mix_fir_ctaps(tk, w0, torch.from_numpy(x))
    assert tr.shape == jr.shape and tr.dtype == torch.float32
    _close_to_pallas(tr.numpy(), jr)
    _close_to_pallas(ti.numpy(), ji)
    # the JAX fn's i32[1, 1] word array is accepted too
    yr, _ = tk.fn(np.asarray([[w0]], np.uint32).view(np.int32), torch.from_numpy(x))
    assert torch.equal(yr.reshape(1, -1), tr)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ctaps_chunked_equals_one_shot_bit_exact(dtype):
    """Phase words are exact u32 ints: two half launches equal one launch."""
    taps, word, hist, n, x, w0 = _fixture(blocks=4)
    k = tct.make_mix_fir_ctaps_kernel(taps, word, 2, out_tile=OT, b_rows=BR, in_dtype=dtype,
                                      device="cpu")
    xt = _port(x, dtype)
    yr, yi = tct.mix_fir_ctaps(k, w0, xt)
    half = n // 2
    ra, ia = tct.mix_fir_ctaps(k, w0, xt[:, :hist + half].contiguous())
    rb, ib = tct.mix_fir_ctaps(k, (w0 + half * word) % (1 << 32), xt[:, half:].contiguous())
    assert torch.equal(torch.cat([ra, rb], -1), yr)
    assert torch.equal(torch.cat([ia, ib], -1), yi)


def test_ctaps_bf16_snr_against_jax_f32_and_bf16():
    taps, word, hist, n, x, w0 = _fixture(blocks=4)
    tk = tct.make_mix_fir_ctaps_kernel(taps, word, 2, out_tile=OT, b_rows=BR, in_dtype=BF16,
                                       device="cpu")
    tr, ti = tct.mix_fir_ctaps(tk, w0, _port(x, BF16))
    assert tr.dtype == torch.float32
    got = _cplx(tr, ti)
    jf = jct.make_mix_fir_ctaps_kernel(taps, word, 2, out_tile=OT, b_rows=BR, interpret=True)
    jb = jct.make_mix_fir_ctaps_kernel(taps, word, 2, out_tile=OT, b_rows=BR,
                                       precision=jax.lax.Precision.DEFAULT,
                                       in_dtype=jnp.bfloat16, interpret=True)
    ref_f = _cplx(*jct.mix_fir_ctaps_pallas(jf, w0, jnp.asarray(x)))
    ref_b = _cplx(*jct.mix_fir_ctaps_pallas(jb, w0, jnp.asarray(x).astype(jnp.bfloat16)))
    assert _snr_db(ref_f, got) > 30.0
    assert _snr_db(ref_b, got) > 30.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_preframed_plain_equals_ctaps_plain_bit_exact(dtype):
    taps, word, hist, n, x, w0 = _fixture(t=33, m=4, freq=-0.21)
    k4 = tct.make_mix_fir_ctaps_kernel(taps, word, 4, out_tile=OT, b_rows=BR, in_dtype=dtype,
                                       device="cpu")
    fn, hist5, stride, span = tpf.make_ctaps_preframed_kernel(
        taps, word, 4, out_tile=OT, b_rows=BR, in_dtype=dtype, device="cpu")
    assert (hist5, stride, span) == (hist, OT * 4, OT * 4 + hist)
    xt = _port(x, dtype)
    fr = tpf.frame_planes(xt, stride, span)
    yr, yi = fn(w0, fr[0], fr[1])
    rr, ri = k4.fn(w0, xt)
    assert torch.equal(yr, rr) and torch.equal(yi, ri)


def test_preframed_plain_matches_pallas_interpret():
    taps, word, hist, n, x, w0 = _fixture(t=64, m=4, freq=0.1743)
    jfn, jhist, stride, span = jpf.make_ctaps_preframed_kernel(
        taps, word, 4, out_tile=OT, b_rows=BR, interpret=True)
    tfn, thist, tstride, tspan = tpf.make_ctaps_preframed_kernel(
        taps, word, 4, out_tile=OT, b_rows=BR, device="cpu")
    assert (jhist, stride, span) == (thist, tstride, tspan)
    jfr = jpf.frame_planes(jnp.asarray(x), stride, span)
    jr, ji = jfn(jnp.asarray(np.asarray([[w0]], np.uint32).view(np.int32)), jfr[0], jfr[1])
    tfr = torch.from_numpy(np.array(jfr))
    tr, ti = tfn(w0, tfr[0].contiguous(), tfr[1].contiguous())
    _close_to_pallas(tr.numpy(), jr)
    _close_to_pallas(ti.numpy(), ji)


@pytest.mark.parametrize("dtype", DTYPES)
def test_frames_match_jax_frame_planes_and_frame_kernel(dtype):
    taps, word, hist, n, x, w0 = _fixture(t=64, m=4, blocks=2)
    stride, span = OT * 4, OT * 4 + hist
    jx = jnp.asarray(x).astype(JAX_DTYPE[dtype])
    ref = np.asarray(jpf.frame_planes(jx, stride, span).astype(jnp.float32))
    jr, ji = jpf.make_frame_kernel(stride, span, b_rows=BR, in_dtype=JAX_DTYPE[dtype],
                                   interpret=True)(jx)
    xt = _port(x, dtype)
    got = tpf.frame_planes(xt, stride, span)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    tr, ti = tpf.make_frame_kernel(stride, span, b_rows=BR, in_dtype=dtype, device="cpu")(xt)
    np.testing.assert_array_equal(tr.float().numpy(), np.asarray(jr.astype(jnp.float32)))
    np.testing.assert_array_equal(ti.float().numpy(), np.asarray(ji.astype(jnp.float32)))
    assert tr.dtype == dtype
    # a leading batch of planes frames each entry alike, and deframe inverts
    br, bi = tpf.make_frame_kernel(stride, span, b_rows=BR, in_dtype=dtype, device="cpu")(
        torch.stack([xt, xt.flip(-1)]))
    assert torch.equal(br[0], tr) and torch.equal(bi[0], ti)
    assert torch.equal(tpf.deframe(br, stride)[1], xt[0].flip(-1))


@pytest.mark.parametrize("stride,span,length", [
    (512, 640, 128 + 1024),       # hist = 128 | 512: valid
    (512, 512 + 96, 96 + 1024),   # hist = 96 does not divide 512
    (512, 512, 1024),             # hist = 0
    (512, 640, 128 + 1000),       # N % stride != 0
])
def test_frame_geometry_errors_as_jax(stride, span, length):
    x = np.zeros((2, length), np.float32)
    try:
        jpf.frame_planes(jnp.asarray(x), stride, span)
        jax_ok = True
    except ValueError:
        jax_ok = False
    if jax_ok:
        assert tpf.frame_planes(torch.from_numpy(x), stride, span).shape[-1] == span
    else:
        with pytest.raises(ValueError):
            tpf.frame_planes(torch.from_numpy(x), stride, span)
    assert jax_ok == (length == 128 + 1024)


def test_wrappers_reject_other_dtype():
    taps, word, hist, n, x, w0 = _fixture()
    stride, span = OT * 2, OT * 2 + hist
    xf, xb = _port(x, torch.float32), _port(x, BF16)
    k4 = tct.make_mix_fir_ctaps_kernel(taps, word, 2, out_tile=OT, b_rows=BR, device="cpu")
    k4b = tct.make_mix_fir_ctaps_kernel(taps, word, 2, out_tile=OT, b_rows=BR, in_dtype=BF16,
                                        device="cpu")
    fn5, *_ = tpf.make_ctaps_preframed_kernel(taps, word, 2, out_tile=OT, b_rows=BR, device="cpu")
    fk = tpf.make_frame_kernel(stride, span, b_rows=BR, in_dtype=BF16, device="cpu")
    frb = tpf.frame_planes(xb, stride, span)
    with pytest.raises(ValueError, match="in_dtype"):
        k4.fn(w0, xb)
    with pytest.raises(ValueError, match="in_dtype"):
        k4b.fn(w0, xf)
    with pytest.raises(ValueError, match="in_dtype"):
        fn5(w0, frb[0], frb[1])
    with pytest.raises(ValueError, match="in_dtype"):
        fk(xf)
    with pytest.raises(ValueError, match="in_dtype"):
        tct.make_mix_fir_ctaps_kernel(taps, word, 2, in_dtype=torch.float16, device="cpu")
    fr = tpf.frame_planes(xf, stride, span)
    with pytest.raises(ValueError, match="b_rows"):
        fn5(w0, fr[0, :-1].contiguous(), fr[1, :-1].contiguous())
    with pytest.raises(ValueError, match="kernel built for cpu"):
        k4.fn(w0, xf.to("meta"))


def test_cpu_tensors_run_plain_versions_without_launching():
    taps, word, hist, n, x, w0 = _fixture()
    stride, span = OT * 2, OT * 2 + hist
    _build.reset_launches()
    xt = torch.from_numpy(x)
    tct.make_mix_fir_ctaps_kernel(taps, word, 2, out_tile=OT, b_rows=BR, device="cpu").fn(w0, xt)
    fr = tpf.make_frame_kernel(stride, span, b_rows=BR, device="cpu")(xt)
    fn5, *_ = tpf.make_ctaps_preframed_kernel(taps, word, 2, out_tile=OT, b_rows=BR, device="cpu")
    assert fn5(w0, *fr)[0].device.type == "cpu"
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_config1_serving_variants_agree():
    """The serving presets on one seed: preframed equals ctaps bit for bit in each
    dtype, and bf16 ingest stays above the 30 dB floor."""
    out = {}
    for v in tconfigs.CONFIG1_SERVING:
        b = tconfigs.build_config1_serving(1 << 15, v, device="cpu")
        assert b.samples_per_call == 1 << 15
        yr, yi = b.step(*b.example)
        out[v] = (yr.reshape(-1), yi.reshape(-1))
    for dt in ("", "_bf16io"):
        assert all(torch.equal(a, b) for a, b in zip(out["ctaps" + dt], out["preframed" + dt]))
    assert _snr_db(_cplx(*out["ctaps"]), _cplx(*out["ctaps_bf16io"])) > 30.0
    with pytest.raises(ValueError, match="variant"):
        tconfigs.build_config1_serving(1 << 15, "kernel", device="cpu")


def test_config1_preframed_bf16io_matches_jax_kernel():
    """The slice: the preframed_bf16io preset's step against the JAX K5 in
    bf16 (bench.py's _make_preframed kernel) on the same frames, > 30 dB."""
    b = tconfigs.build_config1_serving(1 << 16, "preframed_bf16io", device="cpu")
    xr_f, xi_f = b.example
    yr, yi = b.step(xr_f, xi_f)
    fn, hist, stride, span = jpf.make_ctaps_preframed_kernel(
        lowpass(64, 0.2), int(freq_to_word(0.11)), 2, out_tile=512, b_rows=32,
        precision=jax.lax.Precision.DEFAULT, in_dtype=jnp.bfloat16, interpret=True)
    assert span == xr_f.shape[-1]
    word0 = (-hist * int(freq_to_word(0.11))) % (1 << 32)
    w0 = jnp.asarray(np.asarray([[word0]], np.uint32).view(np.int32))
    jr, ji = fn(w0, jnp.asarray(xr_f.float().numpy()).astype(jnp.bfloat16),
                jnp.asarray(xi_f.float().numpy()).astype(jnp.bfloat16))
    assert _snr_db(_cplx(jr, ji), _cplx(yr, yi)) > 30.0
