"""Port vs JAX package: kernels K2 (fsk_fused) and K3 (fsk_ctaps).

The plain PyTorch versions (what the wrappers run on a CPU tensor) are held
against the Pallas kernels in interpret mode (out_tile=128, b_rows=2) on the
same planes, for both lane orders. Tolerances: soft symbols atol 1e-4
cycles/sample (atan2f vs the TPU kernel's polynomial, |err| < 3e-7 rad, plus
float32 sums in another order), bits equal, O&M sums rtol 1e-4 / atol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.kernels import fsk_ctaps as jct
from srcdsp_tpu.kernels import fsk_fused as jff
from srcdsp_tpu.kernels.mixfir_ctaps import _banded_pack
from srcdsp_tpu.ops.nco import freq_to_word
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu.testing.signals import fsk_baseband, random_bits, tone
from srcdsp_tpu_torch.kernels import fsk_ctaps as tct
from srcdsp_tpu_torch.kernels import fsk_fused as tff
from srcdsp_tpu_torch.kernels import mixfir as tmf

NCH, DECIM, SPS, OT = 2, 4, 8, 128


def _fixture(nsym=512):
    centers = [0.11 + 0.01 * c for c in range(NCH)]
    bits = random_bits(jax.random.PRNGKey(0), (NCH, nsym))
    bb = fsk_baseband(bits, DECIM * SPS, 0.05 / DECIM)
    x = np.asarray(bb) * np.stack([np.asarray(tone(bb.shape[-1], c)) for c in centers])
    words = np.asarray([freq_to_word(-c) for c in centers], np.uint32)
    hist = 128
    blk = 2 * OT * DECIM
    x = x[:, :(x.shape[-1] // blk) * blk]
    xpad = np.concatenate([np.zeros((NCH, hist), np.complex64), x], axis=1)
    planes = np.stack([xpad.real, xpad.imag], axis=1).astype(np.float32)
    return words, planes, hist


def _compare(jout, tout, jd, td, jst, tst):
    (_, (jbits, jsoft)), (_, (tbits, tsoft)) = jout, tout
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(tsoft.numpy(), np.asarray(jsoft), atol=1e-4)
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("class_major", [False, True])
def test_fsk_fused_plain_matches_pallas_interpret(class_major):
    words, planes, hist = _fixture()
    taps = lowpass(64, 0.03)
    jfn, jhist = jff.make_fsk_mc_kernel(taps, DECIM, NCH, SPS, out_tile=OT, b_rows=2,
                                        class_major=class_major, interpret=True)
    tfn, thist = tff.make_fsk_mc_kernel(taps, DECIM, NCH, SPS, out_tile=OT, b_rows=2,
                                        class_major=class_major)
    assert jhist == thist == hist
    words0 = np.asarray([(-hist * int(w)) % (1 << 32) for w in words], np.uint32)
    jout = jff.fsk_demod_fused(jfn, hist, OT, words0, words, jnp.asarray(planes), SPS,
                               class_major=class_major)
    tout = tff.fsk_demod_fused(tfn, hist, OT, words0, words, torch.as_tensor(planes), SPS,
                               class_major=class_major)
    w0 = jnp.asarray(words0.view(np.int32).reshape(-1, 1))
    dw = jnp.asarray(words.view(np.int32).reshape(-1, 1))
    jd, jst = jfn(w0, dw, jnp.asarray(planes))
    # the port's fn also takes the JAX fn's int32 [C, 1] word arrays
    td, tst = tfn(np.asarray(w0), np.asarray(dw), torch.as_tensor(planes))
    _compare(jout, tout, jd, td, jst, tst)


@pytest.mark.parametrize("class_major", [False, True])
def test_fsk_ctaps_plain_matches_pallas_interpret(class_major):
    words, planes, hist = _fixture()
    taps = lowpass(64, 0.03)
    jfn, jhist = jct.make_fsk_ctaps_kernel(taps, words, DECIM, SPS, out_tile=OT, b_rows=2,
                                           class_major=class_major, interpret=True)
    tfn, thist = tct.make_fsk_ctaps_kernel(taps, words, DECIM, SPS, out_tile=OT, b_rows=2,
                                           class_major=class_major)
    assert jhist == thist == hist
    jout = jct.fsk_demod_ctaps(jfn, hist, OT, jnp.asarray(planes), SPS,
                               class_major=class_major)
    tout = tct.fsk_demod_ctaps(tfn, hist, OT, torch.as_tensor(planes), SPS,
                               class_major=class_major)
    jd, jst = jfn(jnp.asarray(planes))
    td, tst = tfn(torch.as_tensor(planes))
    _compare(jout, tout, jd, td, jst, tst)


def _closure(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def test_ctaps_host_taps_and_deltas_bit_equal():
    """The port's host-built complex taps and deltas are the JAX kernel's:
    its banded 3-matmul pack of the port's taps, and its deltas, bit for bit."""
    taps = lowpass(64, 0.03)
    words = np.asarray([freq_to_word(-0.11 - 0.07 * c) for c in range(5)], np.uint32)
    jfn, hist = jct.make_fsk_ctaps_kernel(taps, words, DECIM, SPS, out_tile=OT, b_rows=2,
                                          interpret=True)
    gr, gi, deltas = tct.ctaps_host(taps, words, DECIM)
    np.testing.assert_array_equal(deltas, np.asarray(_closure(jfn, "deltas"))[:, 0])
    hsubs = np.asarray(_closure(jfn, "hsubs"))
    for c in range(len(words)):
        pack = _banded_pack(gr[c] + 1j * gi[c].astype(np.float64), DECIM, OT, hist, 128)
        np.testing.assert_array_equal(pack, hsubs[c])
        bands_r = tmf.banded_taps(gr[c], DECIM, OT, hist, 128)
        np.testing.assert_array_equal(bands_r, hsubs[c][..., :128])


def test_seam_and_chunk_join_match_jax():
    """Output 0 of each call has d = 0; the second chunk's rows past the seam
    sample equal the one-shot call's, as in the JAX kernel."""
    words, planes, hist = _fixture(nsym=1024)
    taps = lowpass(64, 0.03)
    tfn, _ = tct.make_fsk_ctaps_kernel(taps, words, DECIM, SPS, out_tile=OT, b_rows=2)
    n = planes.shape[-1] - hist
    half = n // 2
    d1, _ = tfn(torch.as_tensor(planes))
    da, _ = tfn(torch.as_tensor(planes[:, :, :hist + half]).contiguous())
    db, _ = tfn(torch.as_tensor(planes[:, :, half:]).contiguous())
    assert torch.all(da[:, 0, 0] == 0) and torch.all(db[:, 0, 0] == 0)
    nt = d1.shape[1] // 2
    assert torch.equal(d1[:, :nt], da)
    assert torch.equal(d1[:, nt + 1:], db[:, 1:])
    assert torch.equal(d1[:, nt, 1:], db[:, 0, 1:])
