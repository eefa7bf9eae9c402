"""Port vs JAX package: the FSK teleprinter protocols, ``chains/{navtex, rtty, same}``.

Inputs are numpy, made from seeds; each receiver's JAX reference runs once
per module on the same audio or IQ as the port.

Contracts:

- bit for bit: the SITOR-B codeword table, encode and decode (clean, with
  DX and RX burst errors, and cut at an RX slot), the NAVTEX message
  grammar; the UART framer and deframer (with resync on a false start),
  ITA2 both ways; the SAME header grammar and its bit stream, `same_modulate`
  (both numpy);
- decisions equal: the receivers `decode_navtex_audio`, `decode_rtty` and
  `decode_same_audio` on the reference tests' links (``tests/e2e/
  test_{navtex,rtty,same}.py``): text, erasures and headers equal, and equal
  to what was sent;
- the modulators `navtex_modulate` and `rtty_modulate` are the port's
  float64-phase `fsk_baseband`: within 2e-3 of the reference's float32 one.
"""

import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import navtex as jn
from srcdsp_tpu.chains import rtty as jr
from srcdsp_tpu.chains import same as js
from srcdsp_tpu_torch.chains import navtex as tn
from srcdsp_tpu_torch.chains import rtty as tr
from srcdsp_tpu_torch.chains import same as ts
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
NAVTEX_MSG = tn.navtex_build("E", "A", "42", "GALE WARNING 10 DOVER 2300 UTC")
RTTY_TEXT = "CQ CQ DE W1AW 599 73 QRZ?"
SAME_HDR = ts.same_build("WXR", "TOR", ["039173", "039051"], "0030", "1051700", "KCLE/NWS")


@pytest.fixture(scope="module")
def navtex_link():
    """tests/e2e/test_navtex.py's link: 100 Bd at sps 20, dev 0.05, noise."""
    rng = np.random.default_rng(1)
    stream = jn.sitor_b_encode(jn._text_codes(NAVTEX_MSG))
    x = np.asarray(jn.navtex_modulate(stream, 20, 0.05))
    x = np.concatenate([x, np.zeros(40 * 20, np.complex64)])
    x = (x + 0.1 * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
         ).astype(np.complex64)
    return stream, x, jn.decode_navtex_audio(x, 20, 0.05)


@pytest.fixture(scope="module")
def rtty_link():
    """tests/e2e/test_rtty.py's link: sps_half 10, dev 0.04, noise."""
    rng = np.random.default_rng(2)
    lv = jr.uart_frame(jr.ita2_encode(RTTY_TEXT), lead_idle=20)
    x = np.concatenate([np.asarray(jr.rtty_modulate(lv, 10, 0.04)), np.ones(200, np.complex64)])
    x = (x + 0.1 * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
         ).astype(np.complex64)
    return lv, x, jr.decode_rtty(x, 10, 0.04)


@pytest.fixture(scope="module")
def same_link():
    """tests/e2e/test_same.py's link: the header three times, then NNNN three
    times, at 12.5 kHz with 0.2 s gaps and noise."""
    fs = 12500.0
    rng = np.random.default_rng(3)
    burst = js.same_modulate(js.same_bytes_bits(SAME_HDR.encode()), fs)
    eom = js.same_modulate(js.same_bytes_bits(b"NNNN"), fs)
    gap = np.zeros(int(0.2 * fs), np.float32)
    audio = np.concatenate([gap, burst, gap, burst, gap, burst, gap, eom, gap, eom, gap, eom, gap])
    audio = (audio + 0.05 * rng.standard_normal(audio.size)).astype(np.float32)
    return audio, js.decode_same_audio(audio, fs)


# --- NAVTEX ----------------------------------------------------------------

def test_sitor_b_codec_bit_for_bit():
    assert tn.CW_TABLE == jn.CW_TABLE
    assert (tn.ALPHA, tn.REP, tn.LTRS, tn.FIGS) == (jn.ALPHA, jn.REP, jn.LTRS, jn.FIGS)
    for code in range(128):
        for figs in (False, True):
            assert tn.code_to_char(code, figs) == jn.code_to_char(code, figs)
    codes = jn._text_codes(NAVTEX_MSG)
    assert tn._text_codes(NAVTEX_MSG) == codes
    stream = jn.sitor_b_encode(codes)
    np.testing.assert_array_equal(tn.sitor_b_encode(codes), stream)
    np.testing.assert_array_equal(tn.sitor_b_encode(codes, 3), jn.sitor_b_encode(codes, 3))
    rng = np.random.default_rng(4)
    burst = stream.copy()
    burst[60:70] = 0                        # wipes DX and RX slots: erasures
    lone = stream.copy()
    lone[rng.choice(np.arange(40, stream.size, 2), 12, replace=False)] = 0   # DX only
    for s in (stream, burst, lone, stream[1:], stream[29:]):
        assert tn.sitor_b_decode(torch.as_tensor(s)) == jn.sitor_b_decode(s)
    assert tn.sitor_b_decode(lone)[0].startswith(NAVTEX_MSG)
    with pytest.raises(ValueError):
        tn._text_codes("#")


def test_navtex_grammar_equals_reference():
    assert NAVTEX_MSG == jn.navtex_build("E", "A", "42", "GALE WARNING 10 DOVER 2300 UTC")
    for text in (NAVTEX_MSG, "noise ZCZC EA4", "xxZCZC AB12\r\nBODY *\r\nNNNNyy", ""):
        assert tn.navtex_parse(text) == jn.navtex_parse(text)
    with pytest.raises(ValueError):
        tn.navtex_build("EE", "A", "42", "x")


def test_navtex_link_equals_reference(navtex_link):
    stream, x, want = navtex_link
    assert np.abs(tn.navtex_modulate(stream, 20, 0.05)
                  - np.asarray(jn.navtex_modulate(stream, 20, 0.05))).max() < 2e-3
    got = tn.decode_navtex_audio(x, 20, 0.05, device=CPU)
    assert got == want
    assert tn.navtex_parse(got[0]) == {"station": "E", "type": "A", "serial": "42",
                                       "body": "GALE WARNING 10 DOVER 2300 UTC"}


# --- RTTY ------------------------------------------------------------------

def test_uart_and_ita2_bit_for_bit():
    codes = jr.ita2_encode(RTTY_TEXT)
    assert tr.ita2_encode(RTTY_TEXT) == codes
    assert tr.ita2_decode(codes) == jr.ita2_decode(codes)
    for kw in ({}, {"data_bits": 8, "stop_bits": 1.0, "lead_idle": 3}):
        lv = jr.uart_frame(codes, **kw)
        np.testing.assert_array_equal(tr.uart_frame(codes, **kw), lv)
        dk = {k: v for k, v in kw.items() if k != "lead_idle"}
        np.testing.assert_array_equal(tr.uart_deframe(torch.as_tensor(lv), **dk),
                                      jr.uart_deframe(lv, **dk))
    lv = jr.uart_frame(codes)
    glitch = np.concatenate([[1, 1, 0, 1, 1, 1], lv])      # a false start edge
    np.testing.assert_array_equal(tr.uart_deframe(glitch), jr.uart_deframe(glitch))
    np.testing.assert_array_equal(tr.uart_deframe(lv, max_chars=5), jr.uart_deframe(lv, max_chars=5))
    with pytest.raises(ValueError):
        tr.ita2_encode("~")


def test_rtty_link_equals_reference(rtty_link):
    lv, x, want = rtty_link
    assert np.abs(tr.rtty_modulate(lv, 10, 0.04)
                  - np.asarray(jr.rtty_modulate(lv, 10, 0.04))).max() < 2e-3
    got = tr.decode_rtty(x, 10, 0.04, device=CPU)
    assert got == want
    assert RTTY_TEXT in got
    assert tr.decode_rtty(torch.as_tensor(x), 10, 0.04) == want


# --- SAME ------------------------------------------------------------------

def test_same_grammar_and_bits_bit_for_bit():
    assert SAME_HDR == js.same_build("WXR", "TOR", ["039173", "039051"], "0030", "1051700",
                                     "KCLE/NWS")
    assert ts.same_build("EAS", "RWT", "012345", "0100", "0010000", "X") == js.same_build(
        "EAS", "RWT", "012345", "0100", "0010000", "X")
    for text in (SAME_HDR, "ZCZC-A-B", "nothing", "ZCZC-ORG-EEE-1+2-3"):
        assert ts.same_parse(text) == js.same_parse(text)
    np.testing.assert_array_equal(ts.same_bytes_bits(b"NNNN", 4), js.same_bytes_bits(b"NNNN", 4))
    bits = js.same_bytes_bits(SAME_HDR.encode())
    np.testing.assert_array_equal(ts.same_modulate(bits), js.same_modulate(bits))
    with pytest.raises(ValueError):
        ts.same_modulate(bits, fs=12000.0)


def test_same_link_equals_reference(same_link):
    audio, want = same_link
    got = ts.decode_same_audio(audio, device=CPU)
    assert got == want
    heads = [t for t in got if t.startswith("ZCZC")]
    assert len(heads) == 3 and all(ts.same_parse(t) == ts.same_parse(SAME_HDR) for t in heads)
    assert sum(t.startswith("NNNN") for t in got) == 3
