"""Port vs JAX package: the polyphase channelizer, its complex tier
(``chains/channelizer``) and its matmul tier (``ops/channelize_planes``).

Contracts:

- ``channelize_full`` / ``channelize_apply`` against JAX at (M, taps per
  phase) = (8, 4), (16, 8), (64, 8): SNR > 110 dB (a fixed-order DFT sum
  against XLA's FFT, both float32);
- block joins equal one shot by ``torch.equal`` (the reference's contract);
- against the C++ oracle's ``channelize`` and ``channelize_stream``: > 100 dB;
- the 2x-oversampled analysis and synthesis against JAX and the oracle, and
  the critically sampled synthesis: > 100 dB;
- the baked E matrices (analysis, os2, synthesis) equal to JAX's bit for bit;
- the plane banks against JAX's: > 100 dB;
- the committed ``chan_8x128`` fixture through ``channelize_full``: > 100 dB
  against its gold;
- a JAX channelizer state continues in the port with no seam.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import channelizer as jc
from srcdsp_tpu.ops import channelize_planes as jcp
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch import oracle as toracle
from srcdsp_tpu_torch.chains import channelizer as tc
from srcdsp_tpu_torch.io.capture import read_capture
from srcdsp_tpu_torch.ops import channelize_planes as tcp
from srcdsp_tpu_torch.testing.signals import tone
from tests.torch_threads import one_torch_thread  # noqa: F401

FIX = Path(__file__).resolve().parent / "fixtures"


def _snr_db(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    err = np.mean(np.abs(got - ref) ** 2)
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2) / (err + 1e-30)))


def _iq(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


CASES = [(8, 4), (16, 8), (64, 8)]


@pytest.mark.parametrize("m,tpp", CASES)
def test_channelize_full_matches_jax_and_oracle(m, tpp):
    h = tc.design_prototype(m, tpp)
    np.testing.assert_array_equal(h, jc.design_prototype(m, tpp))
    x = _iq(np.random.default_rng(m), m * 96)
    got = tc.channelize_full(h, torch.from_numpy(x), m)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (m, 96)
    ref = np.asarray(jc.channelize_full(h, jnp.asarray(x), m))
    assert _snr_db(ref, got.numpy()) > 110
    assert _snr_db(toracle.channelize(x, h, m), got.numpy()) > 100


@pytest.mark.parametrize("m,tpp", CASES)
def test_channelize_block_joins_bit_exact(m, tpp):
    h = tc.design_prototype(m, tpp)
    x = _iq(np.random.default_rng(m + 1), 2, m * 120)
    whole = tc.channelize_full(h, torch.from_numpy(x), m)
    st = tc.channelizer_init(h, m, (2,), device="cpu")
    jst = jc.channelizer_init(h, m, (2,))
    parts, off = [], 0
    for frames in (7, 64, 1, 48):
        xb = x[:, off:off + frames * m]
        st, y = tc.channelize_apply(h, st, torch.from_numpy(xb), m)
        jst, jy = jc.channelize_apply(h, jst, jnp.asarray(xb), m)
        np.testing.assert_array_equal(st.tail.numpy(), np.asarray(jst.tail))
        assert _snr_db(np.asarray(jy), y.numpy()) > 110
        parts.append(y)
        off += frames * m
    assert torch.equal(torch.cat(parts, dim=-1), whole)


def test_channelize_stream_matches_oracle_stream():
    m = 16
    h = tc.design_prototype(m, 8)
    x = _iq(np.random.default_rng(3), m * 200)
    st = tc.channelizer_init(h, m, device="cpu")
    hist = np.zeros(h.size - 1, np.complex64)
    for lo, hi in ((0, 48), (48, 50), (50, 200)):
        xb = x[lo * m:hi * m]
        st, y = tc.channelize_apply(h, st, torch.from_numpy(xb), m)
        ref, hist = toracle.channelize_stream(xb, h, m, hist)
        assert _snr_db(ref, y.numpy()) > 100
        np.testing.assert_array_equal(st.tail.numpy(), hist)


def test_channelize_bad_block_rejected():
    h = tc.design_prototype(8, 4)
    with pytest.raises(ValueError, match="num_channels"):
        tc.channelize_full(h, torch.zeros(100, dtype=torch.complex64), 8)
    with pytest.raises(ValueError, match="hop"):
        tc.channelize_os2_full(h, torch.zeros(102, dtype=torch.complex64), 8)
    with pytest.raises(ValueError, match="even"):
        tc.channelize_os2_full(tc.design_prototype(5, 4), torch.zeros(10, dtype=torch.complex64), 5)


def test_tone_lands_in_its_channel():
    m, ch = 16, 5
    h = tc.design_prototype(m, 8)
    y = tc.channelize_full(h, torch.from_numpy(tone(m * 128, ch / m)), m).numpy()
    power = (np.abs(y[:, 32:]) ** 2).mean(axis=-1)
    assert power.argmax() == ch
    assert 10 * np.log10(power[ch] / np.delete(power, ch).max()) > 50.0


@pytest.mark.parametrize("m,tpp", CASES)
def test_synthesis_matches_jax_and_oracle(m, tpp):
    h = tc.design_prototype(m, tpp)
    y = _iq(np.random.default_rng(m + 5), m, 40)
    st, x = tc.synthesize_apply(h, tc.synthesizer_init(h, m, device="cpu"), torch.from_numpy(y), m)
    jst, jx = jc.synthesize_apply(h, jc.synthesizer_init(h, m), jnp.asarray(y), m)
    assert tuple(x.shape) == (40 * m,) and x.dtype == torch.complex64
    assert _snr_db(np.asarray(jx), x.numpy()) > 110
    assert _snr_db(np.asarray(jst.tail), st.tail.numpy()) > 110
    assert _snr_db(toracle.synthesize(y, h, m), x.numpy()) > 100


@pytest.mark.parametrize("m,tpp", CASES)
def test_os2_analysis_and_synthesis_match_jax_and_oracle(m, tpp):
    h = tc.design_prototype(m, tpp)
    x = _iq(np.random.default_rng(m + 7), m * 48)
    got = tc.channelize_os2_full(h, torch.from_numpy(x), m)
    assert tuple(got.shape) == (m, 96)
    assert _snr_db(np.asarray(jc.channelize_os2_full(h, jnp.asarray(x), m)), got.numpy()) > 100
    assert _snr_db(toracle.channelize_os2(x, h, m), got.numpy()) > 100
    y = got.numpy()
    st, xs = tc.synthesize_os2_apply(h, tc.synthesizer_os2_init(h, m, device="cpu"),
                                     torch.from_numpy(y), m)
    _, jxs = jc.synthesize_os2_apply(h, jc.synthesizer_os2_init(h, m), jnp.asarray(y), m)
    assert tuple(xs.shape) == (48 * m,)
    assert _snr_db(np.asarray(jxs), xs.numpy()) > 100
    assert _snr_db(toracle.synthesize_os2(y, h, m), xs.numpy()) > 100
    assert tuple(st.tail.shape) == ((2 * (h.size // m) - 1) * m,)


@pytest.mark.parametrize("m,tpp", CASES)
def test_baked_matrices_bit_equal(m, tpp):
    h = tc.design_prototype(m, tpp)
    for tf, jf in ((tcp.make_channelizer_mats, jcp.make_channelizer_mats),
                   (tcp.make_channelizer_os2_mats, jcp.make_channelizer_os2_mats),
                   (tcp.make_synthesizer_mats, jcp.make_synthesizer_mats)):
        for a, b in zip(tf(h, m), jf(h, m)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m,tpp", [(8, 4), (16, 8)])
def test_plane_banks_match_jax(m, tpp):
    h = tc.design_prototype(m, tpp)
    rng = np.random.default_rng(m + 11)
    xr, xi = rng.standard_normal((2, m * 64)).astype(np.float32)
    for tmake, jmake in ((tcp.make_channelize_planes, jcp.make_channelize_planes),
                         (tcp.make_channelize_os2_planes, jcp.make_channelize_os2_planes)):
        yr, yi = tmake(h, m, device="cpu")(torch.from_numpy(xr), torch.from_numpy(xi))
        jr, ji = jmake(h, m)(jnp.asarray(xr), jnp.asarray(xi))
        assert _snr_db(np.asarray(jr) + 1j * np.asarray(ji), yr.numpy() + 1j * yi.numpy()) > 100
    # the plane bank is the complex tier transposed
    yr, yi = tcp.make_channelize_planes(h, m, device="cpu")(torch.from_numpy(xr),
                                                            torch.from_numpy(xi))
    full = tc.channelize_full(h, torch.complex(torch.from_numpy(xr), torch.from_numpy(xi)), m)
    assert _snr_db(full.numpy().T, yr.numpy() + 1j * yi.numpy()) > 110
    y = _iq(rng, 64, m)
    sr, si = tcp.make_synthesize_planes(h, m, device="cpu")(
        torch.from_numpy(np.ascontiguousarray(y.real)), torch.from_numpy(np.ascontiguousarray(y.imag)))
    jr, ji = jcp.make_synthesize_planes(h, m)(jnp.asarray(y.real), jnp.asarray(y.imag))
    assert _snr_db(np.asarray(jr) + 1j * np.asarray(ji), sr.numpy() + 1j * si.numpy()) > 100


def test_chan_8x128_fixture_matches_gold():
    meta = json.loads((FIX / "chan_8x128.fixture.json").read_text())
    x, _ = read_capture(str(FIX / "chan_8x128.ci16"))
    h = np.load(FIX / "chan_8x128_proto.npy")
    gold = np.load(FIX / "chan_8x128_gold.npy")
    got = tc.channelize_full(h, torch.from_numpy(np.ascontiguousarray(x)), meta["channels"])
    assert _snr_db(gold, got.numpy()) > 100


def test_channelizer_state_from_jax_continues():
    m = 8
    h = tc.design_prototype(m, 8)
    x = _iq(np.random.default_rng(9), m * 80)
    jst, _ = jc.channelize_apply(h, jc.channelizer_init(h, m), jnp.asarray(x[:m * 30]), m)
    st = convert.channelizer_state_from(jst, device="cpu")
    _, y2 = tc.channelize_apply(h, st, torch.from_numpy(x[m * 30:]), m)
    whole = tc.channelize_full(h, torch.from_numpy(x), m)
    assert torch.equal(y2, whole[:, 30:])
