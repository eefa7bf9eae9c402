"""Port vs JAX package: overlap-save FFT convolution in its three tiers,
``ops/fftconv`` (torch.fft), ``ops/fftconv_planes`` (matrix FFT) and the
fused kernel K11's plain version (``kernels/fftconv_pallas``), and the
state converters.

Contracts:

- ``ops/fftconv`` against JAX ``fftconv_full``/``fftconv_apply`` on the
  reference's cases: SNR > 120 dB (two complex64 FFT libraries); against the
  port's direct FIR: > 100 dB (the reference's bar); block joins bit-exact;
- ``ops/fftconv_planes`` against JAX: > 100 dB; against the C++ oracle:
  rel < 1e-4 (the reference's bar);
- K11: geometry (hop, overlap, n1, block_in) equal to the JAX kernel's and
  the same ``pipelined`` ValueError; the plain version against JAX
  ``fftconv_pallas(interpret=True)`` for shared and per-channel taps:
  > 100 dB; chunked calls and `FftConvStream` equal to one call bit for bit;
- a stream or state started by the JAX package continues in the port with
  no seam (bit-exact against the port's own one-shot run).

The tiers hop differently at 1024 taps and fft 4096 (3073, 2048, 3072), so
they are compared on a common prefix from zero history, never index for
index on differently rounded lengths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.kernels.fftconv_pallas import FftConvStream as JStream
from srcdsp_tpu.kernels.fftconv_pallas import fftconv_pallas as jfftconv_pallas
from srcdsp_tpu.kernels.fftconv_pallas import make_fftconv_kernel as jmake_kernel
from srcdsp_tpu.ops import fftconv as jfc
from srcdsp_tpu.ops.fftconv_planes import make_fftconv_planes as jmake_planes
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch import oracle as toracle
from srcdsp_tpu_torch.kernels import fftconv_pallas as kfc
from srcdsp_tpu_torch.ops import fftconv as tfc
from srcdsp_tpu_torch.ops.fftconv_planes import make_fftconv_planes
from srcdsp_tpu_torch.ops.fir import fir_full
from tests.torch_threads import one_torch_thread  # noqa: F401


def _snr_db(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    err = np.mean(np.abs(got - ref) ** 2)
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2) / (err + 1e-30)))


def _iq(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("num_taps,fft_size,hop", [(129, 512, None), (64, 256, None),
                                                   (257, 4096, None), (65, 1024, 960)])
def test_fftconv_matches_jax_and_direct_fir(num_taps, fft_size, hop):
    h = lowpass(num_taps, 0.15)
    step = hop or tfc.default_hop(num_taps, fft_size)
    x = _iq(np.random.default_rng(num_taps), 3, 8 * step)
    got = tfc.fftconv_full(h, torch.from_numpy(x), fft_size, hop=hop)
    ref = jfc.fftconv_full(h, jnp.asarray(x), fft_size, hop=hop)
    assert got.dtype == torch.complex64 and got.shape == x.shape
    assert _snr_db(np.asarray(ref), got.numpy()) > 120
    assert _snr_db(fir_full(h, torch.from_numpy(x)).numpy(), got.numpy()) > 100


def test_fftconv_block_joins_bit_exact_and_match_jax():
    h = lowpass(129, 0.15)
    fft_size = 1024
    hop = tfc.default_hop(129, fft_size)                  # 896
    x = _iq(np.random.default_rng(0), 2, 6 * hop)
    whole = tfc.fftconv_full(h, torch.from_numpy(x), fft_size)
    hr = tfc.make_freq_response(h, fft_size, device="cpu")
    jh = jfc.make_freq_response(h, fft_size)
    assert _snr_db(np.asarray(jh), hr.numpy()) > 120
    st = tfc.fftconv_init(129, fft_size, (2,), device="cpu")
    jst = jfc.fftconv_init(129, fft_size, (2,))
    outs, off = [], 0
    for b in (hop, 3 * hop, 2 * hop):
        st, y = tfc.fftconv_apply(hr, 129, st, torch.from_numpy(x[:, off:off + b]))
        jst, jy = jfc.fftconv_apply(jh, 129, jst, jnp.asarray(x[:, off:off + b]))
        assert _snr_db(np.asarray(jy), y.numpy()) > 120
        np.testing.assert_array_equal(st.tail.numpy(), np.asarray(jst.tail))
        outs.append(y)
        off += b
    assert torch.equal(torch.cat(outs, dim=-1), whole)


def test_fftconv_bad_hop_rejected():
    with pytest.raises(ValueError, match="hop"):
        tfc.fftconv_init(129, 1024, hop=1000, device="cpu")
    h = tfc.make_freq_response(lowpass(129, 0.15), 1024, device="cpu")
    st = tfc.fftconv_init(129, 1024, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tfc.fftconv_apply(h, 129, st, torch.zeros(1000, dtype=torch.complex64))
    with pytest.raises(ValueError, match="num_taps"):
        tfc.make_freq_response(np.ones(300), 256, device="cpu")


def test_fftconv_state_from_jax_continues():
    h = lowpass(129, 0.15)
    hop = tfc.default_hop(129, 1024)
    x = _iq(np.random.default_rng(5), 2, 4 * hop)
    jst, _ = jfc.fftconv_apply(jfc.make_freq_response(h, 1024), 129,
                               jfc.fftconv_init(129, 1024, (2,)), jnp.asarray(x[:, :hop]))
    st = convert.fftconv_state_from(jst, device="cpu")
    _, y2 = tfc.fftconv_apply(tfc.make_freq_response(h, 1024, device="cpu"), 129, st,
                              torch.from_numpy(x[:, hop:]))
    whole = tfc.fftconv_full(h, torch.from_numpy(x), 1024)
    assert torch.equal(y2, whole[:, hop:])


@pytest.mark.parametrize("t,f", [(129, 512), (1024, 4096)])
def test_fftconv_planes_matches_jax_and_oracle(t, f):
    taps = lowpass(t, 0.1)
    fn, hop = make_fftconv_planes(taps, f, device="cpu")
    jfn, jhop = jmake_planes(taps, f)
    assert hop == jhop
    x = _iq(np.random.default_rng(t), 8 * hop)
    xpad = np.concatenate([np.zeros(f - hop, np.complex64), x])
    xr, xi = np.ascontiguousarray(xpad.real), np.ascontiguousarray(xpad.imag)
    yr, yi = fn(torch.from_numpy(xr), torch.from_numpy(xi))
    got = yr.numpy() + 1j * yi.numpy()
    jr, ji = jfn(jnp.asarray(xr), jnp.asarray(xi))
    assert _snr_db(np.asarray(jr) + 1j * np.asarray(ji), got) > 100
    ref = toracle.fir(x, taps)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-4


def test_fftconv_planes_hop_rules():
    taps = lowpass(1024, 0.1)
    assert make_fftconv_planes(taps, 4096, device="cpu")[1] == 2048
    with pytest.raises(ValueError, match="% hop"):
        make_fftconv_planes(taps, 4096, hop=3072, device="cpu")
    with pytest.raises(ValueError, match="not in"):
        make_fftconv_planes(taps, 4096, hop=4096, device="cpu")


@pytest.mark.parametrize("channels,num_taps,fft,b_frames", [(1, 1024, 4096, 16), (4, 1024, 4096, 2),
                                                            (2, 200, 2048, 2), (1, 2800, 4096, 1)])
def test_kernel_geometry_equals_jax(channels, num_taps, fft, b_frames):
    taps = lowpass(num_taps, 0.05)
    jk = jmake_kernel(taps, fft, num_channels=channels, b_frames=b_frames, interpret=True)
    tk = kfc.make_fftconv_kernel(taps, fft, num_channels=channels, b_frames=b_frames,
                                 device="cpu")
    for name in ("fft_size", "hop", "overlap", "num_taps", "n1", "n2", "b_frames",
                 "num_channels"):
        assert getattr(tk, name) == getattr(jk, name), name
    assert tk.block_in() == jk.block_in()
    if (num_taps, fft) == (1024, 4096):
        assert (tk.hop, tk.overlap, tk.block_in() // b_frames) == (3072, 1024, 3072)


def test_kernel_pipelined_gate_like_jax():
    taps = lowpass(2800, 0.05)
    for make in (lambda **kw: jmake_kernel(taps, 4096, interpret=True, **kw),
                 lambda **kw: kfc.make_fftconv_kernel(taps, 4096, device="cpu", **kw)):
        with pytest.raises(ValueError, match="pipelined"):
            make(b_frames=1, pipelined=True)
        k = make(b_frames=1)
        assert (k.overlap, k.hop) == (24 * 128, 8 * 128)
    with pytest.raises(ValueError, match="per-channel"):
        kfc.make_fftconv_kernel(np.ones((3, 64)), 1024, num_channels=2, device="cpu")


def _zero_hist_planes(rng, c, overlap, n):
    x = rng.standard_normal((c, 2, overlap + n)).astype(np.float32)
    x[:, :, :overlap] = 0.0
    return x


@pytest.mark.parametrize("channels,num_taps,fft,per_channel", [
    (1, 1024, 4096, False), (4, 1024, 4096, False), (2, 200, 2048, False),
    (3, 200, 2048, True)])
def test_kernel_plain_matches_jax_interpret(channels, num_taps, fft, per_channel):
    if per_channel:
        taps = np.stack([lowpass(num_taps, 0.05 * (c + 1)) for c in range(channels)])
    else:
        taps = lowpass(num_taps, 0.1)
    jk = jmake_kernel(taps, fft, num_channels=channels, b_frames=2, interpret=True)
    tk = kfc.make_fftconv_kernel(taps, fft, num_channels=channels, b_frames=2, device="cpu")
    x = _zero_hist_planes(np.random.default_rng(channels), channels, tk.overlap,
                          2 * tk.block_in())
    jr, ji = jfftconv_pallas(jk, jnp.asarray(x))
    tr, ti = kfc.fftconv_pallas(tk, torch.from_numpy(x))
    assert tuple(tr.shape) == tuple(jr.shape) == (channels, 2 * tk.block_in())
    got = tr.numpy() + 1j * ti.numpy()
    for c in range(channels):
        assert _snr_db(np.asarray(jr[c]) + 1j * np.asarray(ji[c]), got[c]) > 100
        h = taps[c] if per_channel else taps
        xc = x[c, 0, tk.overlap:] + 1j * x[c, 1, tk.overlap:]
        assert _snr_db(toracle.fir(xc, h), got[c]) > 100


def test_tiers_agree_on_common_prefix():
    """1024 taps at fft 4096: hops 3073, 2048 and 3072; from zero history the
    three tiers agree on the samples all of them cover."""
    taps = lowpass(1024, 0.1)
    rng = np.random.default_rng(11)
    k = kfc.make_fftconv_kernel(taps, 4096, b_frames=2, device="cpu")
    n = 2 * k.block_in()                                  # 12288
    x = _iq(rng, n)
    planes = np.zeros((1, 2, k.overlap + n), np.float32)
    planes[0, 0, k.overlap:], planes[0, 1, k.overlap:] = x.real, x.imag
    kr, ki = kfc.fftconv_pallas(k, torch.from_numpy(planes))
    yk = kr.numpy()[0] + 1j * ki.numpy()[0]
    m = (n // 3073) * 3073
    yo = tfc.fftconv_full(taps, torch.from_numpy(x[:m]), 4096).numpy()
    fn, hop = make_fftconv_planes(taps, 4096, device="cpu")
    xp = np.concatenate([np.zeros(4096 - hop, np.complex64), x])
    pr, pi = fn(torch.from_numpy(np.ascontiguousarray(xp.real)),
                torch.from_numpy(np.ascontiguousarray(xp.imag)))
    yp = pr.numpy() + 1j * pi.numpy()
    assert _snr_db(yo, yk[:m]) > 100 and _snr_db(yo, yp[:m]) > 100


def test_kernel_chunks_and_stream_bit_identical():
    taps = lowpass(256, 0.2)
    k = kfc.make_fftconv_kernel(taps, 2048, num_channels=2, b_frames=2, device="cpu")
    n = 4 * k.block_in()
    raw = np.random.default_rng(3).standard_normal((2, 2, n)).astype(np.float32)
    full = np.concatenate([np.zeros((2, 2, k.overlap), np.float32), raw], axis=-1)
    yr, yi = kfc.fftconv_pallas(k, torch.from_numpy(full))
    half = n // 2
    a = kfc.fftconv_pallas(k, torch.from_numpy(full[..., :k.overlap + half].copy()))
    b = kfc.fftconv_pallas(k, torch.from_numpy(full[..., half:].copy()))
    assert torch.equal(torch.cat([a[0], b[0]], -1), yr)
    assert torch.equal(torch.cat([a[1], b[1]], -1), yi)
    st = kfc.FftConvStream(k)
    parts = [st.process(torch.from_numpy(raw[..., lo:hi].copy()))
             for lo, hi in ((0, k.block_in()), (k.block_in(), 3 * k.block_in()),
                            (3 * k.block_in(), n))]
    assert torch.equal(torch.cat([p[0] for p in parts], -1), yr)
    assert torch.equal(torch.cat([p[1] for p in parts], -1), yi)
    assert st.hist.shape == (2, 2, k.overlap) and st.hist.is_contiguous()


def test_kernel_rejects_bad_input():
    k = kfc.make_fftconv_kernel(lowpass(256, 0.2), 2048, num_channels=2, b_frames=2,
                                device="cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        kfc.fftconv_pallas(k, torch.zeros(2, 2, k.overlap + k.block_in() + 128))
    with pytest.raises(ValueError, match="shape"):
        kfc.fftconv_pallas(k, torch.zeros(3, 2, k.overlap + k.block_in()))
    with pytest.raises(ValueError, match="float32"):
        kfc.fftconv_pallas(k, torch.zeros(2, 2, k.overlap + k.block_in(), dtype=torch.float64))


def test_stream_from_jax_continues_with_no_seam():
    taps = lowpass(256, 0.2)
    jk = jmake_kernel(taps, 2048, num_channels=2, b_frames=2, interpret=True)
    tk = kfc.make_fftconv_kernel(taps, 2048, num_channels=2, b_frames=2, device="cpu")
    n = 2 * tk.block_in()
    raw = np.random.default_rng(6).standard_normal((2, 2, 2 * n)).astype(np.float32)
    js = JStream(jk)
    js.process(jnp.asarray(raw[..., :n]))
    jr2, _ = js.process(jnp.asarray(raw[..., n:]))
    js1 = JStream(jk)
    js1.process(jnp.asarray(raw[..., :n]))
    ts = convert.fftconv_stream_from(js1, tk)
    r2, i2 = ts.process(torch.from_numpy(raw[..., n:].copy()))
    whole = kfc.FftConvStream(tk)
    wr, wi = whole.process(torch.from_numpy(raw))
    assert torch.equal(r2, wr[:, n:]) and torch.equal(i2, wi[:, n:])
    assert _snr_db(np.asarray(jr2), r2.numpy()) > 100
    with pytest.raises(ValueError, match="hist"):
        convert.fftconv_stream_from(JStream(jmake_kernel(taps, 2048, num_channels=1,
                                                         interpret=True)), tk)
