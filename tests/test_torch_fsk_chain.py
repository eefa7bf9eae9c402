"""Port vs JAX package: the FSK chains, the stream classes, state carried
across packages, the recorded fixture and the config presets.

Tolerances: soft symbols atol 1e-4 cycles/sample, bits equal; the fixture's
bits equal the C++ oracle's gold bits exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import configs as jconfigs
from srcdsp_tpu.chains import fsk as jfsk
from srcdsp_tpu.chains import fsk_planes as jfp
from srcdsp_tpu.chains.sync import TimingState as JTimingState
from srcdsp_tpu.kernels import fsk_ctaps as jct
from srcdsp_tpu.kernels.mixfir import make_mix_fir_kernel_mc as jmake_mc
from srcdsp_tpu.ops.fir import FirState as JFirState
from srcdsp_tpu.ops.nco import NcoState as JNcoState
from srcdsp_tpu.ops.nco import freq_to_word
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu.testing import signals as jsignals
from srcdsp_tpu_torch import configs as tconfigs
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.chains import fsk as tfsk
from srcdsp_tpu_torch.chains import fsk_planes as tfp
from srcdsp_tpu_torch.io.capture import read_capture
from srcdsp_tpu_torch.kernels import fsk_ctaps as tct
from srcdsp_tpu_torch.kernels.mixfir import make_mix_fir_kernel_mc as tmake_mc
from srcdsp_tpu_torch.testing import signals as tsignals

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
DECIM, SPS, DEV = 4, 8, 0.05


def _signal(nch, nsym, seed=0):
    """nch FSK channels at centers 0.11 + 0.01*c (the reference's generators)."""
    centers = [0.11 + 0.01 * c for c in range(nch)]
    bits = np.asarray(jsignals.random_bits(jax.random.PRNGKey(seed), (nch, nsym)))
    bb = np.asarray(jsignals.fsk_baseband(jnp.asarray(bits), DECIM * SPS, DEV / DECIM))
    x = bb * np.stack([np.asarray(jsignals.tone(bb.shape[-1], c)) for c in centers])
    words = np.asarray([freq_to_word(-c) for c in centers], np.uint32)
    return bits, x.astype(np.complex64), words


def _ber(b, r, settle=16):
    best = np.ones(b.shape[0])
    for lag in range(-16, 17):
        bs, rs = settle + max(lag, 0), settle + max(-lag, 0)
        n = min(b.shape[-1] - bs, r.shape[-1] - rs)
        best = np.minimum(best, np.mean(b[:, bs:bs + n] != r[:, rs:rs + n], axis=-1))
    return best


def _planes(x):
    return np.stack([x.real, x.imag], axis=1).astype(np.float32)


def _same(jout, tout):
    jbits, jsoft = (np.asarray(a) for a in jout)
    tbits, tsoft = (a.numpy() for a in tout)
    np.testing.assert_allclose(tsoft, jsoft, atol=1e-4)
    np.testing.assert_array_equal(tbits, jbits)


def test_fsk_apply_matches_jax_over_blocks():
    _, x, _ = _signal(2, 256)
    jp = jfsk.make_fsk_params(0.11, 64, 0.03, DECIM, SPS, DEV)
    tp = tfsk.make_fsk_params(0.11, 64, 0.03, DECIM, SPS, DEV, device="cpu")
    np.testing.assert_array_equal(tp.taps.numpy(), np.asarray(jp.taps))
    js, ts = jfsk.fsk_init(jp, (2,)), tfsk.fsk_init(tp, (2,))
    blk = 2048
    for b in range(x.shape[-1] // blk):
        xb = x[:, b * blk:(b + 1) * blk]
        js, jout = jfsk.fsk_apply(jp, js, jnp.asarray(xb))
        ts, tout = tfsk.fsk_apply(tp, ts, torch.as_tensor(xb))
        _same(jout, tout)
        np.testing.assert_array_equal(ts.nco.phase.numpy(), np.asarray(js.nco.phase))


def test_fsk_demod_stream_matches_jax():
    _, x, _ = _signal(1, 128)
    jp = jfsk.make_fsk_params(0.11, 64, 0.03, DECIM, SPS, DEV)
    tp = tfsk.make_fsk_params(0.11, 64, 0.03, DECIM, SPS, DEV, device="cpu")
    jb, js = jfsk.fsk_demod_stream(jp, jnp.asarray(x[0]), 1024)
    tb, ts = tfsk.fsk_demod_stream(tp, torch.as_tensor(x[0]), 1024)
    _same((jb, js), (tb, ts))


def test_recorded_fixture_gold_bits():
    with open(os.path.join(FIX, "fsk_256sym.fixture.json")) as f:
        meta = json.load(f)
    x, _ = read_capture(os.path.join(FIX, "fsk_256sym.ci16"))
    params = tfsk.make_fsk_params(meta["center"], meta["taps"], meta["cutoff"],
                                  meta["decim"], meta["sps"], meta["dev"], device="cpu")
    _, (bits, _) = tfsk.fsk_apply(params, tfsk.fsk_init(params), torch.as_tensor(x))
    gold = np.load(os.path.join(FIX, "fsk_256sym_gold_bits.npy"))
    np.testing.assert_array_equal(bits.numpy(), gold)


def test_state_converted_from_jax_continues_without_seam():
    """JAX runs block 1; its state, converted, drives the port's block 2, which
    equals JAX's block 2. The port's state converts back for JAX's block 3."""
    _, x, _ = _signal(2, 192)
    jp = jfsk.make_fsk_params(0.11, 64, 0.03, DECIM, SPS, DEV, timing_forget=0.7)
    tp = convert.fsk_params_from(jp, device="cpu")
    assert convert.fsk_params_to_numpy(tp)["freq_word"] == np.asarray(jp.freq_word)
    blk = 2048
    xb = [x[:, i * blk:(i + 1) * blk] for i in range(3)]
    js, _ = jfsk.fsk_apply(jp, jfsk.fsk_init(jp, (2,)), jnp.asarray(xb[0]))
    js2, jout2 = jfsk.fsk_apply(jp, js, jnp.asarray(xb[1]))
    ts2, tout2 = tfsk.fsk_apply(tp, convert.fsk_state_from(js, device="cpu"),
                                torch.as_tensor(xb[1]))
    _same(jout2, tout2)
    a = convert.fsk_state_to_numpy(ts2)
    back = jfsk.FskState(
        nco=JNcoState(phase=jnp.asarray(a["nco_phase"])),
        fir=JFirState(tail=jnp.asarray(a["fir_tail"])),
        disc_last=jnp.asarray(a["disc_last"]),
        timing=JTimingState(acc=jnp.asarray(a["timing_acc"]),
                            last=jnp.asarray(a["timing_last"])))
    np.testing.assert_array_equal(a["nco_phase"], np.asarray(js2.nco.phase))
    _, jout3 = jfsk.fsk_apply(jp, js2, jnp.asarray(xb[2]))
    _, jout3b = jfsk.fsk_apply(jp, back, jnp.asarray(xb[2]))
    _same(jout3, tuple(torch.as_tensor(np.array(v)) for v in jout3b))


def test_fsk_planes_stream_matches_jax():
    nch = 2
    _, x, words = _signal(nch, 512, seed=3)
    taps = lowpass(64, 0.03)
    jk = jmake_mc(taps, DECIM, nch, out_tile=128, b_rows=2, interpret=True)
    tk = tmake_mc(taps, DECIM, nch, out_tile=128, b_rows=2, device="cpu")
    n = (x.shape[-1] // (2 * jk.block_in())) * 2 * jk.block_in()
    half = n // 2
    tc, ts = jfp.make_timing_tone(half // DECIM, SPS)
    jstream = jfp.FskPlanesStream(jk, words, SPS, jnp.asarray(tc), jnp.asarray(ts), nch)
    tstream = tfp.FskPlanesStream(tk, words, SPS, tc, ts, nch)
    raw = _planes(x[:, :n])
    for lo in (0, half):
        chunk = raw[..., lo:lo + half]
        _same(jstream.process(jnp.asarray(chunk)),
              tstream.process(torch.as_tensor(chunk).contiguous()))


def test_fsk_ctaps_stream_matches_jax():
    nch = 2
    _, x, words = _signal(nch, 1024)
    taps = lowpass(64, 0.03)
    jstream = jct.FskCtapsStream(taps, words, DECIM, SPS, nch, out_tile=128, b_rows=2,
                                 interpret=True)
    tstream = tct.FskCtapsStream(taps, words, DECIM, SPS, nch, out_tile=128, b_rows=2, device="cpu")
    blk = 2 * 128 * DECIM
    n = (x.shape[-1] // (2 * blk)) * 2 * blk
    raw = _planes(x[:, :n])
    for lo in (0, n // 2):
        chunk = raw[..., lo:lo + n // 2]
        _same(jstream.process(jnp.asarray(chunk)),
              tstream.process(torch.as_tensor(chunk).contiguous()))


def test_slice_config4_small_ber_zero_equal_to_jax():
    """The slice end to end at 4 channels x 512 symbols: the serving stream
    (K3) decodes every channel at BER 0 with the JAX package's bits."""
    nch = 4
    bits, x, words = _signal(nch, 512)
    taps = lowpass(64, 0.03)
    jstream = jct.FskCtapsStream(taps, words, DECIM, SPS, nch, out_tile=128, b_rows=2,
                                 interpret=True)
    tstream = tct.FskCtapsStream(taps, words, DECIM, SPS, nch, out_tile=128, b_rows=2, device="cpu")
    raw = _planes(x)
    jb, _ = jstream.process(jnp.asarray(raw))
    tb, _ = tstream.process(torch.as_tensor(raw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert np.all(_ber(bits, tb.numpy()) == 0.0)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_config1_preset_matches_jax(use_kernel):
    n = 1 << 14
    jb = jconfigs.build_config1(n, use_pallas=use_kernel, interpret=True)
    tb = tconfigs.build_config1(n, use_kernel=use_kernel, device="cpu")
    assert tb.samples_per_call == jb.samples_per_call
    for te, je in zip(tb.example, jb.example):
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    jr, ji = jb.step(*jb.example)
    tr, ti = tb.step(*tb.example)
    ref = np.asarray(jr) + 1j * np.asarray(ji)
    got = tr.numpy() + 1j * ti.numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5


def test_config4_preset_decodes():
    b = tconfigs.build_config4(nsym=256, channels=3, device="cpu")
    _, (bits, _) = b.step(*b.example)
    assert np.all(_ber(b.meta["bits"], bits.numpy()) == 0.0)


def test_port_signal_generators_match_jax():
    bits = np.random.default_rng(4).integers(0, 2, (2, 64)).astype(np.int32)
    ref = np.asarray(jsignals.fsk_baseband(jnp.asarray(bits), 32, 0.0125))
    np.testing.assert_allclose(tsignals.fsk_baseband(bits, 32, 0.0125), ref, atol=1e-4)
    np.testing.assert_array_equal(tsignals.tone(4096, 0.11), jsignals.np_tone(4096, 0.11))
    rb = tsignals.random_bits(np.random.default_rng(0), (3, 1000))
    assert rb.dtype == np.int32 and set(np.unique(rb)) == {0, 1}
