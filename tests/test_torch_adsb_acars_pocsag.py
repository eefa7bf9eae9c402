"""Port vs JAX package: ``chains/{adsb, acars, pocsag}``.

Inputs are numpy, made from seeds; the JAX references run once per module.
The reference's POCSAG word corrector calls its BCH decode and encode eagerly
once per word (15 s for three batches on the CPU); `jit_bch` runs those
same two JAX functions jitted once (the reference's math, compiled).

Contracts:

- bit for bit: the Mode S CRC and frames, the PPM waveform, the ACARS
  character layer, BCS and frames, the POCSAG codewords (FSC and IDLE among
  them), transmissions, numeric and alpha codecs;
- decisions equal: ADS-B preamble candidates (order included), slicing and
  both frame decoders on a noisy capture of frames at every arrival phase,
  at sps_half 1 and 2; ACARS blocks from audio (the port's bits equal the
  reference's) and `parse_acars_chars` on clean and corrupted blocks;
  POCSAG pages from transmissions with 0, 1, 2 and 3 bit errors in every
  word (corrected counts included) and from a 2-FSK link fed the same IQ;
- the modulators: `acars_modulate` within float32 rounding of the
  reference's (both numpy); `pocsag_baseband` (the port's float64-phase
  `fsk_baseband`) within 2e-3 of the reference's float32 one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.bch import bch_decode as j_bch_decode
from srcdsp_tpu.bch import bch_encode as j_bch_encode
from srcdsp_tpu.chains import acars as jc
from srcdsp_tpu.chains import adsb as jd
from srcdsp_tpu.chains import pocsag as jp
from srcdsp_tpu.chains.fsk import fsk_apply as j_fsk_apply
from srcdsp_tpu.chains.fsk import fsk_init as j_fsk_init
from srcdsp_tpu.chains.fsk import make_fsk_params as j_make_fsk_params
from srcdsp_tpu_torch.chains import acars as tc
from srcdsp_tpu_torch.chains import adsb as td
from srcdsp_tpu_torch.chains import fsk as tfsk
from srcdsp_tpu_torch.chains import pocsag as tp
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"


@pytest.fixture(scope="module")
def jit_bch():
    dec = jax.jit(lambda r: j_bch_decode(jp._CODE, r))
    enc = jax.jit(lambda m: j_bch_encode(jp._CODE, m))
    mp = pytest.MonkeyPatch()
    mp.setattr(jp, "bch_decode", lambda code, r: dec(r))
    mp.setattr(jp, "bch_encode", lambda code, m: enc(m))
    yield
    mp.undo()


# --- ADS-B -----------------------------------------------------------------

@pytest.fixture(scope="module")
def adsb_capture():
    """8 DF17-shaped frames at random arrival phases in noise, per sps_half."""
    rng = np.random.default_rng(3)
    out = {}
    for sps in (1, 2):
        frames = [jd.build_frame(np.concatenate([[1, 0, 0, 0, 1], rng.integers(0, 2, 83)]))
                  for _ in range(8)]
        n = 9000 * sps
        cap = (0.05 * np.abs(rng.standard_normal(n))).astype(np.float32)
        for k, f in enumerate(frames):
            w = jd.modulate(f, sps_half=sps)
            s0 = 300 * sps + k * 1000 * sps + int(rng.integers(0, 2 * sps))
            cap[s0: s0 + w.size] += w
        out[sps] = (frames, cap, jd.detect_preambles(cap, sps), jd.decode_frame(cap, sps),
                    jd.decode_all_frames(cap, sps))
    return out


def test_modes_crc_frames_and_waveform_bit_for_bit():
    rng = np.random.default_rng(0)
    for n in (32, 88):
        p = rng.integers(0, 2, n).astype(np.int32)
        f = td.build_frame(p)
        np.testing.assert_array_equal(f, jd.build_frame(p))
        assert td.modes_crc(f) == jd.modes_crc(f) == 0
        f[5] ^= 1
        assert td.modes_crc(torch.as_tensor(f)) == jd.modes_crc(f) != 0
        for sps in (1, 3):
            np.testing.assert_array_equal(td.modulate(f, sps, 0.7), jd.modulate(f, sps, 0.7))


@pytest.mark.parametrize("sps", [1, 2])
def test_adsb_decoders_equal_reference(adsb_capture, sps):
    frames, cap, starts_j, one_j, all_j = adsb_capture[sps]
    starts = td.detect_preambles(torch.as_tensor(cap), sps)
    np.testing.assert_array_equal(starts, starts_j)
    for s in starts_j[:20]:
        a, b = td.slice_bits(cap, int(s), 112, sps), jd.slice_bits(cap, int(s), 112, sps)
        assert (a is None and b is None) or np.array_equal(a, b)
    bits, ok, s0 = td.decode_frame(cap, sps)
    assert ok == one_j[1] and s0 == one_j[2] and np.array_equal(bits, one_j[0])
    got = td.decode_all_frames(cap, sps)
    assert [s for _, s in got] == [s for _, s in all_j]
    for (a, _), (b, _) in zip(got, all_j):
        np.testing.assert_array_equal(a, b)
    assert [tuple(b) for b, _ in got] == [tuple(f) for f in frames]


def test_adsb_nothing_found_equals_reference():
    quiet = np.full(4000, 0.1, np.float32)
    assert td.decode_frame(quiet) == jd.decode_frame(quiet) == (None, False, -1)
    assert td.decode_all_frames(quiet) == jd.decode_all_frames(quiet) == []


# --- ACARS -----------------------------------------------------------------

@pytest.fixture(scope="module")
def acars_link():
    """Three blocks at 48 kHz (sps 20) between noise, AM audio noise 0.1."""
    rng = np.random.default_rng(4)
    texts = [b"POS N4512.3 W07322.1", b"ETA 1432", b"WX REQ KBOS"]
    parts = [0.1 * rng.standard_normal(4000)]
    for k, t in enumerate(texts):
        bits = jc.build_acars_frame(t, address=f".N1234{k}", label="H1", bid=str(k + 1))
        parts += [jc.acars_modulate(bits, 20, 48000.0), 0.1 * rng.standard_normal(3000)]
    audio = np.concatenate(parts)
    audio = (audio + 0.1 * rng.standard_normal(audio.size)).astype(np.float32)
    return texts, audio, jc.demod_acars_bits(audio, 20, 48000.0), jc.decode_acars_audio(
        audio, 20, 48000.0)


def test_acars_char_layer_bcs_and_frames_bit_for_bit():
    rng = np.random.default_rng(5)
    chars = rng.integers(0, 256, 40)
    np.testing.assert_array_equal(tc.char_bits(chars), jc.char_bits(chars))
    np.testing.assert_array_equal(tc.bits_chars(jc.char_bits(chars)), jc.bits_chars(jc.char_bits(chars)))
    assert tc.acars_bcs(chars) == jc.acars_bcs(chars)
    assert tc.acars_bcs(list(b"123456789")) == jc.acars_bcs(list(b"123456789"))
    f = tc.build_acars_frame(b"HELLO ACARS", address=".G-ABCD", label="Q0", bid="7")
    np.testing.assert_array_equal(f, jc.build_acars_frame(b"HELLO ACARS", address=".G-ABCD",
                                                          label="Q0", bid="7"))
    body = jc.bits_chars(f[128 + 40: (f.size // 8) * 8])
    assert tc.parse_acars_chars(body) == jc.parse_acars_chars(body)
    bad = body.copy()
    bad[15] ^= 0x04
    assert tc.parse_acars_chars(torch.as_tensor(bad)) == jc.parse_acars_chars(bad)
    assert tc.parse_acars_chars(body[:10]) is None and jc.parse_acars_chars(body[:10]) is None
    np.testing.assert_allclose(tc.acars_modulate(f, 20), jc.acars_modulate(f, 20), atol=2e-6)


def test_acars_audio_link_equals_reference(acars_link):
    texts, audio, bits_j, rec_j = acars_link
    np.testing.assert_array_equal(tc.demod_acars_bits(audio, 20, device=CPU).numpy(), bits_j)
    rec = tc.decode_acars_audio(audio, 20, device=CPU)
    assert rec == rec_j
    assert [r["text"].encode() for r in rec] == texts and all(r["bcs_ok"] for r in rec)
    assert tc.decode_acars_audio(torch.as_tensor(audio), 20, max_blocks=2) == rec_j[:2]


# --- POCSAG ----------------------------------------------------------------

PAGES = [(1234567, 0, jp.encode_numeric("5551234")), (2097147, 3, jp.encode_alpha("HELLO")),
         (8, 1, jp.encode_numeric("0123456789*U -)(")), (77777, 2, [])]


def test_pocsag_codewords_and_codecs_bit_for_bit(jit_bch):
    rng = np.random.default_rng(6)
    for _ in range(4):
        info = rng.integers(0, 2, 21).astype(np.int32)
        np.testing.assert_array_equal(tp.make_codeword(info), jp.make_codeword(info))
    for const in (tp.FSC, tp.IDLE):
        bits = np.asarray([(const >> (31 - i)) & 1 for i in range(32)], np.int32)
        np.testing.assert_array_equal(tp.make_codeword(bits[:21]), bits)
    np.testing.assert_array_equal(tp.address_codeword(1234567, 2), jp.address_codeword(1234567, 2))
    np.testing.assert_array_equal(tp.message_codeword(0xABCDE), jp.message_codeword(0xABCDE))
    for s in ("5551234", "0123456789*U -)(", ""):
        assert tp.encode_numeric(s) == jp.encode_numeric(s)
        assert tp.decode_numeric(jp.encode_numeric(s)) == jp.decode_numeric(jp.encode_numeric(s))
    for s in ("HELLO WORLD", "a", "Pager 42!"):
        assert tp.encode_alpha(s) == jp.encode_alpha(s)
        assert tp.decode_alpha(jp.encode_alpha(s)) == jp.decode_alpha(jp.encode_alpha(s))
    np.testing.assert_array_equal(tp.encode_transmission(PAGES), jp.encode_transmission(PAGES))


@pytest.mark.parametrize("nerr", [0, 1, 2, 3])
def test_pocsag_decode_with_word_errors_equals_reference(jit_bch, nerr):
    rng = np.random.default_rng(10 + nerr)
    bits = jp.encode_transmission(PAGES, preamble_bits=64)
    words = bits[64:].reshape(-1, 32).copy()
    for w in words:
        if nerr and rng.random() < 0.9 and not (w == tp._int_to_bits(tp.FSC, 32)).all():
            w[rng.choice(32, nerr, replace=False)] ^= 1
    rx = np.concatenate([rng.integers(0, 2, 37), bits[:64], words.reshape(-1)]).astype(np.int32)
    got = tp.decode_transmission(torch.as_tensor(rx))
    assert got == jp.decode_transmission(rx)
    if nerr <= 2:
        assert [(p["ric"], p["func"], p["data"]) for p in got] == [
            (r, f, list(d)) for r, f, d in PAGES]


def test_pocsag_fsk_link_equals_reference(jit_bch):
    """tests/e2e/test_pocsag.py's link: sps 8, dev 0.05, AWGN."""
    sps, dev = 8, 0.05
    rng = np.random.default_rng(7)
    bits = jp.encode_transmission(PAGES)
    bb_j = np.asarray(jp.pocsag_baseband(bits, sps, dev))
    bb_t = tp.pocsag_baseband(bits, sps, dev)
    assert np.abs(bb_t - bb_j).max() < 2e-3
    x = np.concatenate([np.zeros(333, np.complex64), bb_j, np.zeros(1024, np.complex64)])
    x = (x + 0.05 * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
         ).astype(np.complex64)
    n = (x.size // sps) * sps
    pj = j_make_fsk_params(0.0, 64, 0.45, decim=1, sps=sps, dev=dev)
    _, (lv_j, _) = jax.jit(lambda s, v: j_fsk_apply(pj, s, v))(j_fsk_init(pj), jnp.asarray(x[:n]))
    lv_t = tfsk.fsk_capture_bits(torch.as_tensor(x), 0.0, 64, 0.45, sps, dev)
    np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))
    got = tp.decode_transmission(lv_t)
    assert got == jp.decode_transmission(np.asarray(lv_j))
    assert [(p["ric"], p["data"]) for p in got] == [(r, list(d)) for r, _, d in PAGES]
