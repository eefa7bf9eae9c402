"""Port vs JAX package: the image and keying protocols,
``chains/{apt, sstv, cw, dcf77}``.

Inputs are numpy, made from seeds; the JAX references run once per module.

Contracts:

- bit for bit: the APT layout, sync trains, word lines and MPX; the SSTV
  schedule and audio; the Morse table, timing and keyed audio; the DCF77
  minute codec and envelope (all host numpy on both sides);
- rel L2 <= 1e-5: `apt_envelope`, `apt_words` and `sstv_inst_freq` (each a
  "same" convolution: `ops.fir.convolve_same` for conv1d's correlation, held
  to numpy at odd and even tap counts, and the receivers at 127 and 128
  taps, where an off-by-one in the crop would show);
- decisions equal: the APT sync offset and lines, the SSTV VIS code and
  its line sync; `decode_cw` (real and complex input) and `dcf77_decode`
  (host numpy both) equal, and equal to what was sent;
- the SSTV divergence, a repair: the reference sums each scan's last pixel
  to the end of the stream (`np.add.reduceat(f, edges[:-1])`), so it
  saturates at white; the port's last pixel is the mean of its own segment
  [edges[-2], edges[-1]). On the same instantaneous frequency every other
  pixel equals the reference's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import apt as ja
from srcdsp_tpu.chains import cw as jc
from srcdsp_tpu.chains import dcf77 as jd
from srcdsp_tpu.chains import sstv as js
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.chains import apt as ta
from srcdsp_tpu_torch.chains import cw as tc
from srcdsp_tpu_torch.chains import dcf77 as td
from srcdsp_tpu_torch.chains import sstv as ts
from srcdsp_tpu_torch.ops.fir import convolve_same
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
REL = 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _smooth(rng, shape, k):
    img = rng.standard_normal(shape)
    img = np.apply_along_axis(lambda r: np.convolve(r, np.ones(k) / k, "same"), 1, img)
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


@pytest.mark.parametrize("m", [1, 2, 5, 6, 127, 128])
def test_convolve_same_equals_numpy(m):
    rng = np.random.default_rng(m)
    x = rng.standard_normal(700).astype(np.float32)
    h = rng.standard_normal(m).astype(np.float32)
    want = np.convolve(x.astype(np.float64), h.astype(np.float64), mode="same")
    got = convolve_same(torch.as_tensor(x), h)
    assert got.shape == (700,) and rel(got, want) <= 1e-6
    got2 = convolve_same(torch.as_tensor(np.stack([x, -x])), h)
    assert rel(got2[1], -want) <= 1e-6


# --- APT -------------------------------------------------------------------

@pytest.fixture(scope="module")
def apt_case():
    """tests/e2e/test_apt.py's round trip: 12 smooth lines, the MPX rotated to
    start mid-line, 127 and 128 envelope taps."""
    rng = np.random.default_rng(0)
    img = _smooth(rng, (12, 909), 9)
    out = {}
    for taps in (127, 128):
        p = ja.make_apt_params(taps=taps)
        lines = ja.apt_build_lines(img)
        mpx = ja.apt_modulate(p, lines)
        cut = 700 * int(p.sps)
        mpx = np.concatenate([mpx[cut:], mpx[:cut]])
        env = ja.apt_envelope(p, jnp.asarray(mpx))
        words = ja.apt_words(p, env)
        out[taps] = (p, img, lines, mpx, np.asarray(env), np.asarray(words),
                     ja.apt_decode_mpx(p, mpx))
    return out


def test_apt_layout_lines_and_mpx_bit_for_bit(apt_case):
    p_j, img, lines, mpx = apt_case[127][:4]
    assert ta.apt_line_layout() == ja.apt_line_layout()
    np.testing.assert_array_equal(ta.apt_sync_a(), ja.apt_sync_a())
    np.testing.assert_array_equal(ta.apt_sync_b(), ja.apt_sync_b())
    np.testing.assert_array_equal(ta.apt_build_lines(img), lines)
    np.testing.assert_array_equal(ta.apt_build_lines(img, img[::-1]),
                                  ja.apt_build_lines(img, img[::-1]))
    p = ta.make_apt_params(device=CPU)
    np.testing.assert_array_equal(p.lp_taps.numpy(), p_j.lp_taps)
    assert (p.fs, p.sps, p.lo, p.hi) == (p_j.fs, p_j.sps, p_j.lo, p_j.hi)
    np.testing.assert_array_equal(ta.apt_modulate(p, lines[:3]), ja.apt_modulate(p_j, lines[:3]))
    with pytest.raises(ValueError):
        ta.make_apt_params(fs=20000.0, device=CPU)


@pytest.mark.parametrize("taps", [127, 128])
def test_apt_receiver_equals_reference(apt_case, taps):
    p_j, img, _, mpx, env_j, words_j, dec_j = apt_case[taps]
    p = convert.apt_params_from_jax(p_j, device=CPU)
    env = ta.apt_envelope(p, mpx)
    assert rel(env, env_j) <= REL
    words = ta.apt_words(p, env)
    assert rel(words, words_j) <= REL
    assert ta.apt_find_sync(words) == pytest.approx(ja.apt_find_sync(words_j), rel=1e-5)
    dec = ta.apt_decode_mpx(p, torch.as_tensor(mpx))
    assert dec["offset"] == dec_j["offset"] == (2080 - 700) % 2080
    assert dec["lines"].shape == dec_j["lines"].shape
    for k in ("lines", "video_a", "video_b"):
        assert rel(dec[k], dec_j[k]) <= REL


# --- SSTV ------------------------------------------------------------------

@pytest.fixture(scope="module")
def sstv_case():
    """tests/e2e/test_sstv.py's round trip, 3 lines: lead-in noise, 20 dB audio
    SNR; 127 and 128 lowpass taps."""
    rng = np.random.default_rng(1)
    out = {}
    for taps in (127, 128):
        p = js.make_sstv_params(height=3, taps=taps)
        img = np.zeros((3, 320, 3), np.float32)
        for c in range(3):
            img[:, :, c] = _smooth(rng, (3, 320), 15)
        audio = js.sstv_modulate(p, img)
        x = np.concatenate([0.02 * rng.standard_normal(3000).astype(np.float32), audio])
        x = (x + 0.1 * rng.standard_normal(x.size)).astype(np.float32)
        f = js.sstv_inst_freq(p, x)
        out[taps] = (p, img, audio, x, f, js.sstv_decode_vis(p, f), js.sstv_decode(p, x))
    return out


def test_sstv_schedule_and_audio_bit_for_bit(sstv_case):
    p_j, img, audio = sstv_case[127][:3]
    p = ts.make_sstv_params(height=3, device=CPU)
    np.testing.assert_array_equal(p.lp_taps.numpy(), p_j.lp_taps)
    assert ts.sstv_schedule(p, img) == js.sstv_schedule(p_j, img)
    np.testing.assert_array_equal(ts.sstv_modulate(p, img), audio)
    np.testing.assert_array_equal(ts.sstv_modulate(p, img, vis=12), js.sstv_modulate(p_j, img, 12))
    with pytest.raises(ValueError):
        ts.make_sstv_params(fs=5000.0, device=CPU)


@pytest.mark.parametrize("taps", [127, 128])
def test_sstv_inst_freq_and_vis_equal_reference(sstv_case, taps):
    p_j, img, _, x, f_j, vis_j, _ = sstv_case[taps]
    p = convert.sstv_params_from_jax(p_j, device=CPU)
    f = ts.sstv_inst_freq(p, x)
    assert f.shape == f_j.shape and rel(f, f_j) <= REL
    assert ts.sstv_decode_vis(p, f) == pytest.approx(vis_j)
    assert vis_j[0] == ts.MARTIN_M1_VIS


def test_sstv_decode_repairs_the_last_pixel(sstv_case, monkeypatch):
    """Both decoders on the port's instantaneous frequency: every pixel but
    each scan's last equal; the reference's last pixel saturates at white,
    the port's is the mean of its own segment (each scan's edges recorded)."""
    p_j, img, _, x, _, _, dec_j = sstv_case[127]
    p = convert.sstv_params_from_jax(p_j, device=CPU)
    f = ts.sstv_inst_freq(p, x).numpy()
    monkeypatch.setattr(js, "sstv_inst_freq", lambda params, audio: f)
    scans = []

    def recorded(ff, edges):
        scans.append((edges, ts_pixel_means(ff, edges)))
        return scans[-1][1]

    ts_pixel_means = ts.pixel_means
    monkeypatch.setattr(ts, "pixel_means", recorded)
    want = js.sstv_decode(p_j, x)
    got = ts.sstv_decode(p, x)
    assert got["ok"] and want["ok"] and got["vis"] == want["vis"] == ts.MARTIN_M1_VIS
    np.testing.assert_array_equal(got["image"][:, :-1, :], want["image"][:, :-1, :])
    assert np.all(want["image"][:, -1, :] == 1.0)
    assert len(scans) == 3 * 3
    last = np.asarray([m[-1] for _, m in scans]).reshape(3, 3)
    for (edges, means) in scans:
        assert means[-1] == pytest.approx(float(f[edges[-2]:edges[-1]].mean()), rel=1e-6)
    np.testing.assert_allclose(got["image"][:, -1, [1, 2, 0]],
                               np.clip((last - 1500.0) / 800.0, 0.0, 1.0), rtol=1e-6)
    assert np.all(got["image"][:, -1, :] < 0.9)
    assert np.abs(dec_j["image"][:, :-1] - got["image"][:, :-1]).max() < 1e-3


def test_pixel_means_last_segment():
    rng = np.random.default_rng(2)
    f = rng.standard_normal(200).astype(np.float32)
    edges = np.asarray([3, 8, 8, 15, 40, 41, 60])
    got = ts.pixel_means(f, edges)
    old = np.add.reduceat(f, edges[:-1]) / np.maximum(np.diff(edges), 1)
    np.testing.assert_array_equal(got[:-1], old[:-1])
    assert got[-1] == pytest.approx(float(f[41:60].mean()), rel=1e-6)
    assert old[-1] == pytest.approx(float(f[41:].sum()) / 19, rel=1e-5)


# --- CW --------------------------------------------------------------------

def test_cw_table_timing_and_audio_bit_for_bit():
    assert tc.MORSE == jc.MORSE
    for text in ("CQ CQ DE W1AW K", "SOS", "73 / 599 ?", ""):
        assert tc.morse_encode_timing(text) == jc.morse_encode_timing(text)
    np.testing.assert_array_equal(tc.cw_modulate("PARIS", 20, 8000.0, 700.0),
                                  jc.cw_modulate("PARIS", 20, 8000.0, 700.0))
    with pytest.raises(ValueError):
        tc.morse_encode_timing("#")


def test_decode_cw_equals_reference():
    rng = np.random.default_rng(3)
    fs = 8000.0
    msg = "CQ CQ DE W1AW K"
    x = tc.cw_modulate(msg, 18.0, fs, 650.0)
    x = np.concatenate([np.zeros(2000, np.float32), x, np.zeros(2000, np.float32)])
    x = (x + 0.08 * rng.standard_normal(x.size)).astype(np.float32)
    got = tc.decode_cw(torch.as_tensor(x), fs)
    assert got == jc.decode_cw(x, fs) and got["text"] == msg
    z = tc.cw_modulate("TEST 73", 22.0, 4000.0, 500.0).astype(np.complex64)
    z = (z * np.exp(2j * np.pi * 0.05 * np.arange(z.size))).astype(np.complex64)
    got = tc.decode_cw(z, 4000.0)
    assert got == jc.decode_cw(z, 4000.0) and got["text"] == "TEST 73"
    quiet = np.zeros(1000, np.float32)
    assert tc.decode_cw(quiet, fs) == jc.decode_cw(quiet, fs)


# --- DCF77 -----------------------------------------------------------------

TIMES = [td.Dcf77Time(58, 23, 31, 7, 12, 99, False), td.Dcf77Time(59, 23, 31, 7, 12, 99, False),
         td.Dcf77Time(0, 0, 1, 1, 1, 0, True)]


def test_dcf77_codec_and_envelope_bit_for_bit():
    for t in TIMES:
        b = td.dcf77_encode_minute(t)
        np.testing.assert_array_equal(b, jd.dcf77_encode_minute(jd.Dcf77Time(*t)))
        assert td.dcf77_decode_minute(b) == t == tuple(jd.dcf77_decode_minute(b))
        bad = b.copy()
        bad[23] ^= 1
        assert td.dcf77_decode_minute(bad) is None and jd.dcf77_decode_minute(bad) is None
    mins = [td.dcf77_encode_minute(t) for t in TIMES]
    np.testing.assert_array_equal(td.dcf77_modulate(mins, 1000.0, 0.2),
                                  jd.dcf77_modulate(mins, 1000.0, 0.2))


def test_dcf77_decode_equals_reference():
    """tests/e2e/test_dcf77.py's capture: a lead-in, noise, an offset."""
    rng = np.random.default_rng(4)
    env = td.dcf77_modulate([td.dcf77_encode_minute(t) for t in TIMES])
    x = np.concatenate([np.full(1234, 1.0, np.float32), env, np.full(800, 1.0, np.float32)])
    x = (x + 0.05 * rng.standard_normal(x.size)).astype(np.float32)
    v, s, m = td.dcf77_envelope_bits(torch.as_tensor(x))
    vj, sj, mj = jd.dcf77_envelope_bits(x)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(s, sj)
    assert m == mj
    got = td.dcf77_decode(x)
    assert got == [td.Dcf77Time(*t) for t in jd.dcf77_decode(x)] == TIMES
    noise = (0.5 + 0.05 * rng.standard_normal(20000)).astype(np.float32)
    assert td.dcf77_decode(noise) == jd.dcf77_decode(noise) == []
