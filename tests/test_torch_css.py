"""Port vs JAX package: the CSS modem, ``chains/css`` and ``chains/css_planes``.

Fixtures (numpy, seeded): sf 7 and 8 at cr 1..4, payloads of 12 bytes, a
batch of 8 coded frames at -6 dB chip SNR (sf 8, cr 4) plus two frames whose
LLRs are corrupted so their CRC fails, and a stream of 3 bursts with timing
and CFO offsets at sf 7. The JAX side runs once per module.

Contracts:

- bit-exact: the host codec (CRC-16, Gray, Hamming, interleaver, whitening,
  frame encode and decode, chirps), the demodulated shifts, the CssSync
  integers (start, tau, ok and the integer part of cfo_bins), payloads and
  ok flags of every decoder, the plane demodulator's shifts (direct and
  four-step);
- `cfo_bins` within 1e-6 bins: its fractional part is the angle of a sum of
  FFT peak products, a float the two FFT libraries round independently
  (equal to the last bit on this fixture);
- rel L2 <= 1e-5 (one pass of float32 arithmetic): the soft LLRs of
  `css_soft_llrs` and `make_css_llr_planes`, the DFT peaks, the derotated
  stream.

The repaired sync (the port's `css_sync` tries the neighbouring (start, eps)
candidates of the reference's two wraps): where the reference decodes, the
CssSync fields above hold; where it fails on a wrap (a preamble near N/2 off
the frame grid, a CFO fraction near half a bin), the port decodes and the
tests name the reference's failure (`test_sync_ambiguities_equal_reference`,
`test_sync_sweep_decodes_every_offset`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import css as jcss
from srcdsp_tpu.chains import css_planes as jcp
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.chains import css as tcss
from srcdsp_tpu_torch.chains import css_planes as tcp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PLEN, FRAMES, REL = 12, 8, 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _payloads(rng, n):
    return [bytes(rng.integers(0, 256, PLEN, dtype=np.uint8)) for _ in range(n)]


def _awgn(rng, x, snr_db):
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    return (x + sigma * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
            ).astype(np.complex64)


@pytest.fixture(scope="module")
def link():
    """sf 8 cr 4: FRAMES coded frames at -6 dB, their JAX plane LLRs, two
    frames corrupted, and the JAX batch decode of those LLRs."""
    rng = np.random.default_rng(0)
    p = jcss.make_css_params(sf=8, cr=4)
    pls = _payloads(rng, FRAMES)
    shifts = np.concatenate([jcss.css_encode_frame(p, q) for q in pls])
    x = _awgn(rng, jcss.css_modulate(p, shifts), -6.0)
    fr = x.reshape(-1, p.n)
    xr, xi = np.ascontiguousarray(fr.real), np.ascontiguousarray(fr.imag)
    nsym = jcss.css_frame_nsym(p, PLEN)
    llr = np.asarray(jcp.make_css_llr_planes(p)(jnp.asarray(xr), jnp.asarray(xi)))
    llr = llr.reshape(FRAMES, nsym, p.sf).copy()
    llr[2, :5] *= -1.0                       # CRC failures
    llr[5] = rng.standard_normal(llr[5].shape).astype(np.float32)
    return dict(p=p, pls=pls, x=x, xr=xr, xi=xi, nsym=nsym, llr=llr,
                batch=jcss.css_decode_frames_soft_batch(p, llr, PLEN),
                soft=[jcss.css_decode_frame_soft(p, llr[f], PLEN) for f in range(FRAMES)])


@pytest.fixture(scope="module")
def stream():
    """sf 7 cr 3: 3 bursts with gaps, a CFO of 0.37 bins, light noise, and
    the JAX receiver's results over it."""
    rng = np.random.default_rng(1)
    p = jcss.make_css_params(sf=7, cr=3)
    pls = _payloads(rng, 3)
    parts = []
    for i, q in enumerate(pls):
        parts += [np.zeros(90 + 53 * i, np.complex64), jcss.css_transmit(p, q)]
    x = np.concatenate(parts + [np.zeros(300, np.complex64)])
    x = x * np.exp(2j * np.pi * 0.37 / p.n * np.arange(x.size))
    x = _awgn(rng, x, 10.0)
    return dict(p=p, pls=pls, x=x, rx=jcss.css_receive_stream(p, x, PLEN),
                sync=jcss.css_sync(p, x), one=jcss.css_receive(p, x, PLEN))


# ---------- the host codec, bit for bit ----------

@pytest.mark.parametrize("nbits", [0, 1, 16, 97, 176])
def test_crc16_equal(nbits):
    bits = np.random.default_rng(nbits).integers(0, 2, nbits)
    assert tcss.crc16_ccitt(bits) == jcss.crc16_ccitt(bits)


@pytest.mark.parametrize("sf", [5, 8, 12])
def test_gray_and_chirps_equal(sf):
    n = 1 << sf
    k = np.arange(n)
    np.testing.assert_array_equal(tcss.gray_encode_shift(k), jcss.gray_encode_shift(k))
    np.testing.assert_array_equal(tcss.gray_decode_shift(k), jcss.gray_decode_shift(k))
    np.testing.assert_array_equal(tcss.base_upchirp(n), jcss.base_upchirp(n))
    np.testing.assert_array_equal(tcss.chirp_symbol(n, 7), jcss.chirp_symbol(n, 7))
    p, tp = jcss.make_css_params(sf), tcss.make_css_params(sf)
    np.testing.assert_array_equal(tcss.css_preamble(tp), jcss.css_preamble(p))
    assert tcss.preamble_len(tp) == jcss.preamble_len(p)


@pytest.mark.parametrize("cr", [1, 2, 3, 4])
def test_hamming_single_errors_equal(cr):
    nibs = (np.arange(16)[:, None] >> (3 - np.arange(4))) & 1
    cw = jcss.hamming_encode_nibbles(nibs, cr)
    np.testing.assert_array_equal(tcss.hamming_encode_nibbles(nibs, cr), cw)
    flips = np.concatenate([np.zeros((1, 4 + cr), np.int64), np.eye(4 + cr, dtype=np.int64)])
    rx = (cw[:, None, :] ^ flips[None]).reshape(-1, 4 + cr)
    np.testing.assert_array_equal(tcss.hamming_decode_nibbles(rx, cr),
                                  jcss.hamming_decode_nibbles(rx, cr))


def test_hamming_cr4_double_error_equals_reference():
    """The reference's cr-4 decoder corrects with p0..p2 only, so a double
    error is miscorrected to another nibble, where an (8,4) SEC-DED decoder
    would flag it. The port keeps that behaviour (the frame's CRC-16 rejects
    such a frame in both): every nibble with every one of the 28 double
    errors decodes to the reference's nibble, and some of those are wrong."""
    nibs = (np.arange(16)[:, None] >> (3 - np.arange(4))) & 1
    cw = jcss.hamming_encode_nibbles(nibs, 4)
    pairs = [(i, j) for i in range(8) for j in range(i + 1, 8)]
    flips = np.zeros((len(pairs), 8), np.int64)
    for r, (i, j) in enumerate(pairs):
        flips[r, [i, j]] = 1
    rx = (cw[:, None, :] ^ flips[None]).reshape(-1, 8)
    got = tcss.hamming_decode_nibbles(rx, 4)
    np.testing.assert_array_equal(got, jcss.hamming_decode_nibbles(rx, 4))
    assert np.any(got != np.repeat(nibs, len(pairs), axis=0))


@pytest.mark.parametrize("sf", [7, 8])
def test_interleaver_and_whitening_equal(sf):
    rng = np.random.default_rng(sf)
    cw = rng.integers(0, 2, (sf, 8))
    sym = jcss.diag_interleave(cw, sf)
    np.testing.assert_array_equal(tcss.diag_interleave(cw, sf), sym)
    np.testing.assert_array_equal(tcss.diag_deinterleave(sym, sf), jcss.diag_deinterleave(sym, sf))
    np.testing.assert_array_equal(tcss.whitening_seq(300, seed=sf), jcss.whitening_seq(300, seed=sf))


@pytest.mark.parametrize("sf,cr", [(7, 1), (7, 4), (8, 2), (8, 3), (8, 4)])
def test_frame_encode_decode_equal(sf, cr):
    rng = np.random.default_rng(10 * sf + cr)
    p, tp = jcss.make_css_params(sf, cr), tcss.make_css_params(sf, cr)
    q = _payloads(rng, 1)[0]
    shifts = jcss.css_encode_frame(p, q)
    np.testing.assert_array_equal(tcss.css_encode_frame(tp, q), shifts)
    assert tcss.css_frame_nsym(tp, PLEN) == jcss.css_frame_nsym(p, PLEN) == shifts.size
    np.testing.assert_array_equal(tcss.css_modulate(tp, shifts), jcss.css_modulate(p, shifts))
    bad = shifts.copy()
    bad[3] ^= 1                                      # one bin off: one bit
    for s in (shifts, bad):
        assert tcss.css_decode_frame(tp, torch.as_tensor(s), PLEN) == jcss.css_decode_frame(p, s, PLEN)


# ---------- device stages ----------

def test_demod_and_soft_llrs_equal(link):
    p = link["p"]
    tp = convert.css_params_from(p)
    x = torch.as_tensor(link["x"])
    k, pk = tcss.css_demod(tp, x)
    jk, jpk = jcss.css_demod(p, jnp.asarray(link["x"]))
    assert k.dtype == torch.int32
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    assert rel(pk.numpy(), jpk) <= REL
    llr = tcss.css_soft_llrs(tp, x)
    assert llr.dtype == torch.float32 and rel(llr.numpy(), jcss.css_soft_llrs(p, link["x"])) <= REL


def test_derotate_equal(stream):
    p = stream["p"]
    x = stream["x"][:4096]
    got = tcss.css_derotate(convert.css_params_from(p), torch.as_tensor(x), 3.37)
    assert rel(got.numpy(), jcss.css_derotate(p, jnp.asarray(x), 3.37)) <= REL


def test_sync_fields_equal(stream):
    got = tcss.css_sync(convert.css_params_from(stream["p"]), stream["x"], device="cpu")
    ref = stream["sync"]
    assert ref.ok and got.ok
    assert (got.start, got.tau) == (ref.start, ref.tau)
    assert round(got.cfo_bins) == round(ref.cfo_bins)
    assert abs(got.cfo_bins - ref.cfo_bins) <= 1e-6


def test_receive_equal(stream):
    tp = convert.css_params_from(stream["p"])
    pay, ok, sync = tcss.css_receive(tp, torch.as_tensor(stream["x"]), PLEN)
    rpay, rok, rsync = stream["one"]
    assert (pay, ok, sync.start, sync.tau) == (rpay, rok, rsync.start, rsync.tau)
    assert ok and pay == stream["pls"][0]


def test_receive_stream_equal(stream):
    got = tcss.css_receive_stream(convert.css_params_from(stream["p"]), stream["x"], PLEN,
                                  device="cpu")
    assert got == stream["rx"]
    assert [g[0] for g in got] == stream["pls"]


# ---------- decoders ----------

def test_soft_batch_decode_equal_including_crc_failures(link):
    tp = convert.css_params_from(link["p"])
    pays, oks = tcss.css_decode_frames_soft_batch(tp, torch.as_tensor(link["llr"]), PLEN)
    rpays, roks = link["batch"]
    assert oks.dtype == bool
    np.testing.assert_array_equal(oks, roks)
    assert pays == rpays
    assert not oks[2] and not oks[5] and oks.sum() == FRAMES - 2
    assert [q for q, o in zip(pays, oks) if o] == [q for q, o in zip(link["pls"], oks) if o]


def test_soft_batch_decode_puts_numpy_on_the_device_asked(link):
    """A numpy LLR array goes to `device` (here the CPU) and decodes as the
    same LLRs given as a tensor."""
    tp = convert.css_params_from(link["p"])
    pays, oks = tcss.css_decode_frames_soft_batch(tp, link["llr"], PLEN, device="cpu")
    assert pays == link["batch"][0]
    np.testing.assert_array_equal(oks, link["batch"][1])


@pytest.mark.parametrize("nbits", [16, 176])
def test_crc16_matrix_equal(nbits):
    m, c0 = tcss._crc16_matrix(nbits)
    rm, rc0 = jcss._crc16_matrix(nbits)
    assert c0 == rc0
    np.testing.assert_array_equal(m, rm)


def test_soft_frame_decode_equal(link):
    tp = convert.css_params_from(link["p"])
    got = [tcss.css_decode_frame_soft(tp, link["llr"][f], PLEN) for f in range(FRAMES)]
    assert got == link["soft"]


# ---------- plane tier ----------

def test_llr_planes_equal(link):
    tp = convert.css_params_from(link["p"])
    fn = tcp.make_css_llr_planes(tp, device="cpu")
    got = fn(torch.as_tensor(link["xr"]), torch.as_tensor(link["xi"]))
    ref = np.asarray(jcp.make_css_llr_planes(link["p"])(jnp.asarray(link["xr"]),
                                                       jnp.asarray(link["xi"])))
    assert got.dtype == torch.float32 and rel(got.numpy(), ref) <= REL


@pytest.mark.parametrize("direct", [True, False])
def test_demod_planes_equal(link, direct):
    p = link["p"]
    args = (link["xr"], link["xi"])
    k, m2 = tcp.make_css_demod_planes(convert.css_params_from(p), direct=direct, device="cpu")(
        *map(torch.as_tensor, args))
    jk, jm2 = jcp.make_css_demod_planes(p, direct=direct)(*map(jnp.asarray, args))
    assert k.dtype == torch.int32
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    assert rel(m2.numpy(), jm2) <= REL


def test_demod_planes_direct_rule():
    """direct=None takes the reference's rule: the fold at N <= 1024, and at
    N = 2048 only at DEFAULT precision, which runs the same float32 here."""
    rng = np.random.default_rng(3)
    p = tcss.make_css_params(sf=11)
    x = torch.as_tensor(tcss.css_modulate(p, rng.integers(0, p.n, 3)).reshape(3, p.n))
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    auto = tcp.make_css_demod_planes(p, device="cpu")(xr, xi)[0]
    fold = tcp.make_css_demod_planes(p, precision="default", device="cpu")(xr, xi)[0]
    want = tcss.css_demod(p, x.reshape(-1))[0]
    assert torch.equal(auto, want) and torch.equal(fold, want)


def test_precision_takes_only_the_reference_values():
    """`precision` keeps the reference's signature: HIGHEST and DEFAULT (as
    strings, jax.lax.Precision members or None for DEFAULT) are accepted and
    run the same float32 products; any other value raises."""
    import jax

    p = tcss.make_css_params(sf=7)
    for prec in ("highest", "default", None, jax.lax.Precision.HIGHEST,
                 jax.lax.Precision.DEFAULT):
        tcp.make_css_demod_planes(p, precision=prec, device="cpu")
        tcp.make_css_llr_planes(p, precision=prec, device="cpu")
    for prec in ("high", jax.lax.Precision.HIGH, "bf16"):
        with pytest.raises(ValueError, match="precision"):
            tcp.make_css_demod_planes(p, precision=prec, device="cpu")
        with pytest.raises(ValueError, match="precision"):
            tcp.make_css_llr_planes(p, precision=prec, device="cpu")


def test_css_params_round_trip():
    p = jcss.make_css_params(sf=9, cr=2, n_up=6)
    tp = convert.css_params_from(p)
    for f in p._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tp, f)), np.asarray(getattr(p, f)))


def _burst(p, t0, cfo, length=None):
    """One clean sf-p burst at chip t0 with a CFO of `cfo` bins and a phase
    of 0.7 rad; `length` fixes the capture size (the JAX side then reuses
    its compiled FFTs across offsets)."""
    tx = jcss.css_transmit(p, bytes(range(PLEN)))
    x = np.zeros(length or t0 + tx.size + 256, np.complex64)
    x[t0:t0 + tx.size] = tx
    return (x * np.exp(2j * np.pi * cfo / p.n * np.arange(x.size) + 0.7j)).astype(np.complex64)


@pytest.mark.parametrize("t0,cfo", [(63, 0.0), (4, 1.5)])
def test_sync_ambiguities_equal_reference(t0, cfo):
    """The reference's sync has two ambiguities (ROADMAP Queue 3): a
    preamble half a symbol off the frame grid (t0 = N/2 - 1 at sf 7) comes
    back a symbol late (start t0 + 13N, tau 63), and a CFO whose fraction is
    half a bin (1.5) is resolved a bin off (cfo_bins 2.5 or 0.5 with tau one
    chip wrong), so the frame fails its CRC. The port's repaired sync tries
    the neighbouring (start, eps) candidates against the sync word and the
    downchirps and decodes both clean bursts: the payload back with `ok`
    True, the start at t0 + 12N, the CFO within 0.01 bins. The reference's
    failure on these inputs is named here: no payload, `ok` False."""
    p = jcss.make_css_params(sf=7, cr=4)
    x = _burst(p, t0, cfo)
    pay, ok, sync = tcss.css_receive(convert.css_params_from(p), x, PLEN, device="cpu")
    rpay, rok, rsync = jcss.css_receive(p, x, PLEN)
    assert (rpay, rok, rsync.ok) == (None, False, True)
    assert (pay, ok, sync.ok) == (bytes(range(PLEN)), True, True)
    assert sync.start == t0 + 12 * p.n and sync.tau == t0
    assert abs(sync.cfo_bins - cfo) <= 0.01
    if cfo == 0.0:
        assert (rsync.start, rsync.tau) == (t0 + 13 * p.n, t0)


@pytest.mark.parametrize("cfo", [0.0, 0.5, 1.5, 2.5])
def test_sync_sweep_decodes_every_offset(cfo):
    """Every offset 0..127 of a clean sf-7 burst at this CFO: the port
    decodes each frame (the reference loses 190 of the 512: 1 at CFO 0, at
    t0 = 63, and 57, 76 and 56 at 0.5, 1.5 and 2.5). Wherever the reference
    decodes too, the port's start, tau and ok equal the reference's and
    cfo_bins is within 1e-6, with one stated exception: at a fraction of
    exactly half a bin the fractional estimate sits on its +-0.5 wrap, whose
    side XLA's and torch's FFT rounding pick independently, so the reference
    may land on the decode-equivalent neighbour (start, tau and cfo_bins all
    one off in the same direction: the data symbols see the same eps - tau)
    where the port lands on the exact pair, or the other way round (44 of
    the 384 half-bin cases on this fixture: 4 at 0.5, 28 at 1.5, 12 at 2.5;
    the test bounds them at a quarter of the offsets). The payloads are
    equal there."""
    p = jcss.make_css_params(sf=7, cr=4)
    tp = convert.css_params_from(p)
    length = p.n + jcss.css_transmit(p, bytes(PLEN)).size + 256
    neighbours = 0
    for t0 in range(p.n):
        x = _burst(p, t0, cfo, length)
        pay, ok, sync = tcss.css_receive(tp, x, PLEN, device="cpu")
        assert (pay, ok) == (bytes(range(PLEN)), True), (t0, sync)
        rpay, rok, rsync = jcss.css_receive(p, x, PLEN)
        if not rok:
            continue
        assert rpay == pay and sync.ok == rsync.ok
        d = sync.start - rsync.start
        if d == 0:
            assert sync.tau == rsync.tau and abs(sync.cfo_bins - rsync.cfo_bins) <= 1e-6, t0
        else:
            assert cfo % 1.0 == 0.5 and abs(d) == 1, (t0, sync, rsync)
            assert sync.tau - rsync.tau == d and abs(sync.cfo_bins - rsync.cfo_bins - d) <= 1e-6
            neighbours += 1
    assert neighbours <= p.n // 4
