"""Port vs JAX package: the HDLC protocols and BLE, ``chains/{ais, ax25, ble}``.

Inputs are numpy, made from seeds; the JAX references run once per module.

The reference's decoders call its CRC, destuffing, flag search and whitening
(jnp, eager or jitted) once per candidate, and each new bit length costs
them a compile: 0.5-4 s on the CPU (measured: `destuff_bits` 1.2-4.1 s,
`ais_fcs` 0.6-1.1 s, `whiten_bits` 0.7-0.9 s a length), so one noisy stream
would take minutes. `reference_twins` runs the reference's loops with
plain-Python twins of those four functions in their place (bit-loop CRC
and LFSR, a run-count destuffer, an exact flag match), each held bit for bit
to the JAX function on a few lengths first (`test_twins_equal_jax`); the
codec tests call the JAX functions themselves.

Contracts:

- bit for bit: the X-25 FCS, NRZI both ways, the HDLC air bits and AIS
  frames of random payloads, the AX.25 address codec and frames, the BLE
  whitening, CRC-24 and advertising frames;
- decisions equal: `decode_ais_frame` (payload, flag, start, and the
  best-formed failure) and `decode_all_ais_frames` on random streams holding
  intact and corrupted frames amid random bits, with and without a bound on
  the end flags; the GMSK AIS link of ``tests/e2e/test_ais.py``, the Bell-202
  AX.25 audio link of ``tests/e2e/test_ax25.py`` and the GFSK BLE link of
  ``tests/e2e/test_ble.py`` (four packets as four channels of one port call)
  fed the same IQ on both sides: levels, records and payloads equal;
  `decode_adv_frame` with access-address errors allowed, where candidates
  tie;
- the modulators: `afsk_modulate` equal to the reference's within float32
  rounding (both are numpy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import ais as ja
from srcdsp_tpu.chains import ax25 as jx
from srcdsp_tpu.chains import ble as jb
from srcdsp_tpu.chains.fsk import fsk_apply as j_fsk_apply
from srcdsp_tpu.chains.fsk import fsk_init as j_fsk_init
from srcdsp_tpu.chains.fsk import make_fsk_params as j_make_fsk_params
from srcdsp_tpu.testing.signals import gmsk_baseband as j_gmsk
from srcdsp_tpu_torch.chains import ais as ta
from srcdsp_tpu_torch.chains import ax25 as tx
from srcdsp_tpu_torch.chains import ble as tb
from srcdsp_tpu_torch.chains import fsk as tfsk
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
J_FCS, J_DESTUFF, J_FLAGS = ja.ais_fcs, ja.destuff_bits, ja.find_flags
J_WHITEN, J_CRC24 = jb.whiten_bits, jb.crc24


def crc_twin(bits, poly, width, init, xorout, reflect):
    """The gf2 CRC register bit by bit: fb = msb ^ u, r = (r << 1) ^ fb*poly."""
    r = init
    for u in np.asarray(bits).reshape(-1):
        fb = ((r >> (width - 1)) & 1) ^ int(u)
        r = ((r << 1) & ((1 << width) - 1)) ^ (poly if fb else 0)
    if reflect:
        r = int(format(r, f"0{width}b")[::-1], 2)
    return r ^ xorout


def fcs_twin(bits):
    return crc_twin(bits, 0x1021, 16, 0xFFFF, 0xFFFF, True)


def destuff_twin(span):
    """Drop each 0 that follows a run of ones of length 5, 10, ...: run[i] is
    i minus the index of the last 0 at or before i."""
    b = np.asarray(span).astype(np.int32)
    i = np.arange(b.size)
    run = i - np.maximum.accumulate(np.where(b == 0, i, -1))
    prev = np.concatenate([[0], run[:-1]])
    return b, ~((b == 0) & (prev > 0) & (prev % 5 == 0)), None


def flags_twin(bits):
    b = np.asarray(bits)
    hits = np.zeros(b.size, bool)
    if b.size >= 8:
        win = np.lib.stride_tricks.sliding_window_view(b, 8)
        hits[: b.size - 7] = (win == ja.FLAG).all(axis=1)
    return hits


def whiten_twin(bits, channel):
    w = 0x40 | channel
    out = []
    for b in np.asarray(bits).reshape(-1):
        o = w & 1
        out.append(int(b) ^ o)
        w >>= 1
        if o:
            w ^= 0x44
    return np.asarray(out, np.int32)


def crc24_twin(pdu_bits):
    val = crc_twin(pdu_bits, 0x00065B, 24, 0x555555, 0, False)
    return ((val >> (23 - np.arange(24))) & 1).astype(np.int32)


@pytest.fixture(scope="module")
def reference_twins():
    mp = pytest.MonkeyPatch()
    mp.setattr(ja, "ais_fcs", fcs_twin)
    mp.setattr(ja, "destuff_bits", destuff_twin)
    mp.setattr(ja, "find_flags", flags_twin)
    mp.setattr(jb, "whiten_bits", whiten_twin)
    mp.setattr(jb, "crc24", crc24_twin)
    yield
    mp.undo()


def _streams(seed: int, count: int):
    """Random bit streams holding AIS frames (some with a bit error or two)
    between random padding: spurious flags and failed pairs included. The
    frames are the port's (equal to the reference's, tested below): the
    reference's stuffer compiles once per length."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        parts = []
        for _ in range(rng.integers(1, 4)):
            parts.append(rng.integers(0, 2, rng.integers(0, 200)))
            pl = bytes(rng.integers(0, 256, rng.integers(3, 25)).astype(np.uint8))
            lv = ta.build_ais_frame(pl)
            if rng.random() < 0.3:
                lv = lv ^ (rng.random(lv.size) < 0.01)
            parts.append(lv)
        parts.append(rng.integers(0, 2, rng.integers(0, 200)))
        out.append(np.concatenate(parts).astype(np.int32))
    return out


def _fsk_levels_jax(x, center, cutoff, sps, dev, decim=1, forget=0.5):
    p = j_make_fsk_params(center, 64, cutoff, decim=decim, sps=sps, dev=dev, timing_forget=forget)
    n = (x.shape[-1] // (decim * sps)) * decim * sps
    _, (lv, _) = jax.jit(lambda s, v: j_fsk_apply(p, s, v))(j_fsk_init(p, x.shape[:-1]),
                                                            jnp.asarray(x[..., :n]))
    return np.asarray(lv)


def _fsk_levels_port(x, center, cutoff, sps, dev, decim=1, forget=0.5):
    p = tfsk.make_fsk_params(center, 64, cutoff, decim=decim, sps=sps, dev=dev,
                             timing_forget=forget, device=CPU)
    n = (x.shape[-1] // (decim * sps)) * decim * sps
    _, (lv, _) = tfsk.fsk_apply(p, tfsk.fsk_init(p, x.shape[:-1]), torch.as_tensor(x[..., :n]))
    return lv.numpy()


@pytest.fixture(scope="module")
def ais_link(reference_twins):
    """tests/e2e/test_ais.py's impaired GMSK link, with three frames."""
    rng = np.random.default_rng(2)
    payloads = [bytes(range(24)), bytes(range(100, 121)), b"\x00\xff" * 9]
    parts = [rng.integers(0, 2, 48)]
    for pl in payloads:
        parts += [ta.build_ais_frame(pl), rng.integers(0, 2, 40)]
    line = np.concatenate(parts)
    x = np.asarray(j_gmsk(jnp.asarray(line), 8, bt=0.4))
    x = x * np.exp(2j * np.pi * 0.003 * np.arange(x.size))
    x = (x + 0.05 * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
         ).astype(np.complex64)
    args = (0.0, 0.45 / 2, 4, 0.25 / 4, 2, 0.95)
    lv_j = _fsk_levels_jax(x, *args).reshape(-1)
    return payloads, x, args, lv_j, ja.decode_all_ais_frames(lv_j)


@pytest.fixture(scope="module")
def ax25_link(reference_twins):
    """tests/e2e/test_ax25.py's Bell-202 link: two APRS frames in noise."""
    fs, sps = 13200.0, 11
    fm, fsp = 1200.0 / fs, 2200.0 / fs
    rng = np.random.default_rng(5)
    lv1 = jx.build_aprs_frame("N0CALL", "!4903.50N/07201.75W-Test 001")
    lv2 = jx.build_ax25_frame("CQ", "W1AW", b"second frame", path=(("RELAY", 0), ("WIDE2", 2)))
    gap = np.zeros(int(0.05 * fs), np.float32)
    audio = np.concatenate([gap, jx.afsk_modulate(lv1, sps, fm, fsp), gap,
                            jx.afsk_modulate(lv2, sps, fm, fsp), gap])
    audio = (audio + 0.08 * rng.standard_normal(audio.size)).astype(np.float32)
    return audio, (sps, fm, fsp), jx.decode_ax25_audio(audio, sps, fm, fsp), (lv1, lv2)


@pytest.fixture(scope="module")
def ble_link(reference_twins):
    """tests/e2e/test_ble.py's GFSK link, four packets of different payloads
    and offsets (same length), CFO 0.004, noise 0.05."""
    rng = np.random.default_rng(2)
    payloads = [bytes(range(k, k + 20)) for k in (0, 7, 50, 200)]
    rows = []
    for k, pl in enumerate(payloads):
        pre = rng.integers(0, 2, 40 + 8 * k)
        air = np.concatenate([pre, jb.build_adv_frame(pl, channel=37)])
        rows.append(np.concatenate([air, rng.integers(0, 2, 64 + 8 * (3 - k))]))
    bits = np.stack(rows)
    x = np.stack([np.asarray(j_gmsk(jnp.asarray(r), 8, bt=0.5)) for r in bits])
    x = x * np.exp(2j * np.pi * 0.004 * np.arange(x.shape[-1]))
    x = (x + 0.05 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
         ).astype(np.complex64)
    args = (0.004, 0.45 / 2, 4, 0.25 / 4, 2, 0.95)
    lv_j = _fsk_levels_jax(x, *args)
    return payloads, x, args, lv_j, [jb.decode_adv_frame(r, channel=37) for r in lv_j]


# --- AIS -------------------------------------------------------------------

def test_twins_equal_jax():
    rng = np.random.default_rng(1)
    for n in (168,):
        b = rng.integers(0, 2, n).astype(np.int32)
        b[10:17] = 1
        b[40:45] = 1
        b[45] = 0
        assert fcs_twin(b) == J_FCS(b)
        jv, jm, _ = J_DESTUFF(jnp.asarray(b))
        tv, tm, _ = destuff_twin(b)
        np.testing.assert_array_equal(np.asarray(jv), tv)
        np.testing.assert_array_equal(np.asarray(jm), tm)
        np.testing.assert_array_equal(np.asarray(J_FLAGS(jnp.asarray(b))), flags_twin(b))
        np.testing.assert_array_equal(whiten_twin(b, 37), J_WHITEN(b, 37))
        np.testing.assert_array_equal(crc24_twin(b), J_CRC24(b))


def test_fcs_nrzi_and_air_bits_bit_for_bit():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 300):
        b = rng.integers(0, 2, n).astype(np.int32)
        assert ta.ais_fcs(b) == fcs_twin(b)
        for level0 in (0, 1):
            np.testing.assert_array_equal(ta.nrzi_encode(b, level0), ja.nrzi_encode(b, level0))
        if n:
            np.testing.assert_array_equal(ta.nrzi_decode(b), ja.nrzi_decode(b))
    b = rng.integers(0, 2, 64).astype(np.int32)
    assert ta.ais_fcs(torch.as_tensor(b)) == ta.ais_fcs(b) == J_FCS(b)
    pl = bytes(rng.integers(0, 256, 21).astype(np.uint8))
    air = ja.build_hdlc_air_bits(pl)
    np.testing.assert_array_equal(ta.build_hdlc_air_bits(pl), air)
    np.testing.assert_array_equal(ta.build_ais_frame(pl, 1),
                                  ja.nrzi_encode(np.concatenate([ja.TRAINING, air]), 1))


@pytest.mark.parametrize("max_ends", [None, 1, 3])
def test_frame_search_equals_reference(reference_twins, max_ends):
    for lv in _streams(11, 6):
        assert ta.decode_all_ais_frames(lv, max_ends) == ja.decode_all_ais_frames(lv, max_ends)
        assert ta.decode_ais_frame(lv, max_ends) == ja.decode_ais_frame(lv, max_ends)


def test_frame_search_failures_and_short_streams_equal_reference(reference_twins):
    """Streams with no clean frame: the best-formed failure, or none."""
    rng = np.random.default_rng(3)
    cases = [rng.integers(0, 2, n).astype(np.int32) for n in (4, 40, 600, 2000)]
    lv = ta.build_ais_frame(bytes(range(20)))
    bad = lv.copy()
    bad[60] ^= 1
    cases += [bad, np.concatenate([rng.integers(0, 2, 100), bad, rng.integers(0, 2, 100)])]
    for c in cases:
        assert ta.decode_ais_frame(c) == ja.decode_ais_frame(c)
        assert ta.decode_all_ais_frames(c) == ja.decode_all_ais_frames(c)


def test_shared_flag_back_to_back_equal_reference(reference_twins):
    a = ta.build_hdlc_air_bits(b"first frame!")
    b = ta.build_hdlc_air_bits(b"second one")
    lv = ja.nrzi_encode(np.concatenate([ja.TRAINING, a, b[8:]]))
    got = ta.decode_all_ais_frames(lv)
    assert got == ja.decode_all_ais_frames(lv)
    assert [p for p, _ in got] == [b"first frame!", b"second one"]


def test_ais_gmsk_link_equals_reference(ais_link):
    payloads, x, args, lv_j, rec_j = ais_link
    lv_t = _fsk_levels_port(x, *args).reshape(-1)
    np.testing.assert_array_equal(lv_t, lv_j)
    rec_t = ta.decode_all_ais_frames(torch.as_tensor(lv_t))
    assert rec_t == rec_j
    assert [p for p, _ in rec_t] == payloads


# --- AX.25 -----------------------------------------------------------------

def test_address_codec_and_frames_bit_for_bit(ax25_link):
    lv1, lv2 = ax25_link[3]
    for call, ssid, last, cmd in (("N0CALL", 7, True, False), ("W1AW", 0, False, True),
                                  ("abc", 15, True, True)):
        enc = tx.encode_address(call, ssid, last, cmd)
        assert enc == jx.encode_address(call, ssid, last, cmd)
        assert tx.decode_address(enc) == jx.decode_address(enc)
    np.testing.assert_array_equal(tx.build_aprs_frame("N0CALL", "!4903.50N/07201.75W-Test 001"),
                                  lv1)
    np.testing.assert_array_equal(
        tx.build_ax25_frame("CQ", "W1AW", b"second frame", path=(("RELAY", 0), ("WIDE2", 2))), lv2)
    payload = ta.decode_all_ais_frames(lv2)[0][0]
    assert tx.parse_ax25(payload) == jx.parse_ax25(payload)
    assert tx.parse_ax25(payload[:15]) is None and jx.parse_ax25(payload[:15]) is None


def test_afsk_modulate_matches_reference(ax25_link):
    lv = ax25_link[3][0]
    a = tx.afsk_modulate(lv, 11, 1200 / 13200, 2200 / 13200)
    b = jx.afsk_modulate(lv, 11, 1200 / 13200, 2200 / 13200)
    np.testing.assert_allclose(a, b, atol=2e-6)


def test_ax25_audio_link_equals_reference(ax25_link):
    audio, (sps, fm, fsp), rec_j, _ = ax25_link
    rec_t = tx.decode_ax25_audio(audio, sps, fm, fsp, device=CPU)
    assert rec_t == rec_j
    assert [r["info"] for r in rec_t] == [b"!4903.50N/07201.75W-Test 001", b"second frame"]
    assert tx.decode_ax25_audio(torch.as_tensor(audio), sps, fm, fsp) == rec_j


# --- BLE -------------------------------------------------------------------

def test_whitening_crc_and_frames_bit_for_bit():
    rng = np.random.default_rng(4)
    for ch in (0, 17, 37, 38, 39):
        for n in (1, 40, 300):
            b = rng.integers(0, 2, n).astype(np.int32)
            np.testing.assert_array_equal(tb.whiten_bits(b, ch), whiten_twin(b, ch))
    for n in (16, 24, 64, 600):
        b = rng.integers(0, 2, n).astype(np.int32)
        np.testing.assert_array_equal(tb.crc24(b), crc24_twin(b))
    b = rng.integers(0, 2, 56).astype(np.int32)
    np.testing.assert_array_equal(tb.whiten_bits(torch.as_tensor(b), 38), J_WHITEN(b, 38))
    np.testing.assert_array_equal(tb.crc24(b), J_CRC24(b))
    for aa in (tb.ADV_ACCESS_ADDRESS, 0x12345679):
        np.testing.assert_array_equal(tb.preamble_bits(aa), jb.preamble_bits(aa))
        np.testing.assert_array_equal(tb.access_address_bits(aa), jb.access_address_bits(aa))
    for n, ch in ((5, 38), (31, 39)):
        pl = bytes(rng.integers(0, 256, n).astype(np.uint8))
        np.testing.assert_array_equal(tb.build_adv_frame(pl, ch), jb.build_adv_frame(pl, ch))


def test_decode_adv_frame_candidates_equal_reference(reference_twins):
    """Access-address errors allowed: many candidates, some tied; corrupted
    CRCs; a stream too short; none found."""
    rng = np.random.default_rng(6)
    frame = jb.build_adv_frame(bytes(range(12)), 37)
    cases = []
    for k in range(4):
        bits = np.concatenate([rng.integers(0, 2, 100 + 9 * k), frame, rng.integers(0, 2, 50)])
        if k % 2:
            bits[150 + k] ^= 1
        cases.append(bits.astype(np.int32))
    cases += [frame[:60], rng.integers(0, 2, 500).astype(np.int32)]
    for bits in cases:
        for err in (0, 2, 6):
            assert tb.decode_adv_frame(bits, 37, max_aa_errors=err) == \
                jb.decode_adv_frame(bits, 37, max_aa_errors=err)


def test_ble_gfsk_link_equals_reference(ble_link):
    payloads, x, args, lv_j, rec_j = ble_link
    lv_t = _fsk_levels_port(x, *args)
    np.testing.assert_array_equal(lv_t, lv_j)
    rec_t = [tb.decode_adv_frame(torch.as_tensor(r), channel=37) for r in lv_t]
    assert rec_t == rec_j
    assert [(p, ok) for p, ok, _ in rec_t] == [(p, True) for p in payloads]
