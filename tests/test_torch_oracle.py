"""The port's FSK, NCO, FIR-stream, int16, CPM-transmit and IIR slices against the
C++ golden oracle (``cpp/oracle/oracle.cc``, bound by
``srcdsp_tpu_torch/oracle.py``), as ``tests/unit/test_oracle.py`` and
``tests/unit/test_tx.py`` hold the reference's.

Contracts (the reference's): integer paths bit-exact (int16 conversions, the
u32 NCO end phase, the CPM phase words); float paths within an SNR floor
(NCO phasor > 120 dB, NCO mix > 100 dB, discriminator > 100 dB, streaming FIR
> 100 dB, the CPM waveform within 2e-6, the streaming IIR > 80 dB); the FSK
chain's bits equal; the oracle's streaming FIR in blocks equal to its
one-shot FIR.
"""

import numpy as np
import torch

from srcdsp_tpu_torch import oracle
from srcdsp_tpu_torch.chains.fsk import discriminate, fsk_apply, fsk_init, make_fsk_params
from srcdsp_tpu_torch.chains.tx import cpm_tx_apply, cpm_tx_init, make_gmsk_tx
from srcdsp_tpu_torch.ops.fir import fir_apply, fir_init
from srcdsp_tpu_torch.ops.iir import dc_block_coeffs, iir_apply, iir_init, make_iir_params
from srcdsp_tpu_torch.ops.nco import freq_to_word, nco_apply, nco_init, nco_phasor
from srcdsp_tpu_torch.ops.window import lowpass
from srcdsp_tpu_torch.testing.signals import fsk_baseband, random_bits, tone
from srcdsp_tpu_torch.types import (
    complex64_to_int16, int16_to_complex64, np_complex64_to_int16, np_int16_to_complex64)
from tests.torch_threads import one_torch_thread  # noqa: F401


def _snr_db(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    e = np.mean(np.abs(ref - got) ** 2)
    return np.inf if e == 0 else 10 * np.log10(np.mean(np.abs(ref) ** 2) / e)


def _noise(n, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2)).astype(np.complex64)


def test_conversions_bit_exact():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(500) * 0.5 + 1j * rng.standard_normal(500)).astype(np.complex64)
    iq_orc = oracle.f32_to_i16(x.view(np.float32))
    np.testing.assert_array_equal(np_complex64_to_int16(x), iq_orc)
    np.testing.assert_array_equal(complex64_to_int16(torch.as_tensor(x)).numpy(), iq_orc)
    back_orc = oracle.i16_to_f32(iq_orc).view(np.complex64)
    np.testing.assert_array_equal(np_int16_to_complex64(iq_orc).view(np.float32),
                                  back_orc.view(np.float32))
    np.testing.assert_array_equal(int16_to_complex64(torch.as_tensor(iq_orc)).numpy(), back_orc)


def test_nco_phase_bit_exact_and_waveform():
    word = int(freq_to_word(0.1234))
    ref = oracle.nco_phasor(0, word, 2048)
    _, got = nco_phasor(word, nco_init(device="cpu"), 2048)
    assert _snr_db(ref, got.numpy()) > 120
    x = _noise(1000, 1)
    word = int(freq_to_word(0.0789))
    ref, end_phase = oracle.nco_mix(x, 0, word)
    st, got = nco_apply(word, nco_init(device="cpu"), torch.as_tensor(x))
    assert int(st.phase) == end_phase
    assert _snr_db(ref, got.numpy()) > 100


def test_discriminator_vs_oracle():
    x = _noise(4096, 2)
    ref = oracle.discriminate(x)
    _, got = discriminate(torch.zeros(1, dtype=torch.complex64), torch.as_tensor(x))
    assert _snr_db(ref, got.numpy()) > 100


def test_fsk_chain_vs_oracle():
    decim, sps, dev, center = 4, 8, 0.05, 0.11
    bits = random_bits(np.random.default_rng(4), (256,))
    bb = fsk_baseband(bits, decim * sps, dev / decim)
    x = bb * tone(bb.shape[-1], center)
    ref_bits = oracle.fsk_demod(x, center, lowpass(64, 0.03), decim, sps)
    params = make_fsk_params(center, 64, 0.03, decim, sps, dev, device="cpu")
    _, (got, _) = fsk_apply(params, fsk_init(params), torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), ref_bits)


def test_fir_stream_vs_oneshot_and_port():
    taps = lowpass(33, 0.2)
    x = _noise(1 << 12, 3)
    ref = oracle.fir(x, taps, decim=2)
    hist, parts = np.zeros(32, np.complex64), []
    for b in range(4):
        y, hist = oracle.fir_stream(x[b * 1024:(b + 1) * 1024], taps, hist, decim=2)
        parts.append(y)
    np.testing.assert_array_equal(np.concatenate(parts), ref)
    st, tparts = fir_init(33, device="cpu"), []
    for b in range(4):
        st, y = fir_apply(torch.as_tensor(taps), st, torch.as_tensor(x[b * 1024:(b + 1) * 1024]),
                          decim=2)
        tparts.append(y.numpy())
    assert _snr_db(ref, np.concatenate(tparts)) > 100


def test_cpm_tx_vs_oracle():
    bits = np.random.default_rng(10).integers(0, 2, 256)
    sps = 8
    p = make_gmsk_tx(0.0, sps=sps, bt=0.3, device="cpu")
    _, got = cpm_tx_apply(p, cpm_tx_init(p), torch.as_tensor(bits))
    want, ph_cpp = oracle.cpm_tx(bits, p.words.numpy(), sps)
    nrz = 2 * bits.astype(np.int64) - 1
    nspan = p.words.shape[0]
    ext = np.concatenate([np.zeros(nspan - 1, np.int64), nrz])
    w = sum(ext[nspan - 1 - j:nspan - 1 - j + bits.size, None] * p.words.numpy().astype(np.int64)[j]
            for j in range(nspan)).reshape(-1)
    ph = ((np.cumsum(w) - w) % (1 << 32)).astype(np.uint32).astype(np.int32)
    np.testing.assert_array_equal(ph, ph_cpp)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def test_iir_stream_vs_port_iir_apply():
    """The oracle's DF2T IIR, state carried over two blocks, against the
    port's block state-space `iir_apply` (both inter-block forms) above 80 dB
    (tests/unit/test_iir.py::test_vs_cpp_oracle_streaming's floor)."""
    x = _noise(4096, seed=7) + np.complex64(0.5 - 0.25j)
    for b, a in ((np.array([0.0675, 0.1349, 0.0675]), np.array([1.0, -1.143, 0.4128])),
                 dc_block_coeffs(0.995)):
        p = make_iir_params(b, a, block=128, device="cpu")
        for form in ("assoc", "scan"):
            st, z = iir_init(p, device="cpu"), None
            for i in range(0, 4096, 2048):
                blk = x[i:i + 2048]
                st, y = iir_apply(p, st, torch.from_numpy(blk), inter_block=form)
                ref, z = oracle.iir_stream(blk, b, a, z)
                assert _snr_db(ref.astype(np.complex128), y.numpy()) > 80
