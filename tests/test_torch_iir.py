"""Port vs JAX package: ``ops/iir`` (both inter-block forms), the SOS
cascade, ``ops/agc``, ``ops/afc`` and ``ops/nco.freq_to_word_traced``, on the
same numpy inputs at the JAX unit tests' shapes.

Contracts: every IIR output above 80 dB against the JAX package and against
the double-precision twin `np_iir_full` (the reference's own floor; float32
block matmuls in another order); the two inter-block forms within atol 1e-4
of each other (the reference's bound); the AGC above 80 dB against JAX and
settled within 5 % of its target; the AFC's per-block estimates within 1e-6
of JAX's and its output above 80 dB; the traced tuning word bit-equal to
JAX's over a sweep that takes in negative frequencies and frequencies >= 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

from srcdsp_tpu.ops import afc as jafc
from srcdsp_tpu.ops import agc as jagc
from srcdsp_tpu.ops import iir as jiir
from srcdsp_tpu.ops.nco import freq_to_word_traced as jword
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.ops import afc as tafc
from srcdsp_tpu_torch.ops import agc as tagc
from srcdsp_tpu_torch.ops import iir as tiir
from srcdsp_tpu_torch.ops.nco import freq_to_word_traced as tword
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
# the JAX side jitted: eager associative_scan dispatches op by op
J_IIR = jax.jit(jiir.iir_apply, static_argnames=("inter_block",))
J_SOS = jax.jit(jiir.sos_apply)
J_AGC = jax.jit(jagc.agc_apply)
J_AFC = jax.jit(jafc.afc_apply)


def _snr_db(ref, got):
    ref = np.asarray(ref, np.complex128)
    err = ref - np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    return 10 * np.log10(np.mean(np.abs(ref) ** 2) / (np.mean(np.abs(err) ** 2) + 1e-30))


def _noise(shape, seed, complex_=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if complex_:
        return (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x.astype(np.float32)


@pytest.mark.parametrize("form", ["assoc", "scan"])
@pytest.mark.parametrize("order,cutoff,block", [(2, 0.1, 128), (4, 0.25, 64), (6, 0.4, 128)])
def test_iir_matches_jax_and_twin(form, order, cutoff, block):
    b, a = sig.butter(order, cutoff)
    x = _noise((2, 2048), seed=order)
    jp = jiir.make_iir_params(b, a, block=block)
    tp = tiir.make_iir_params(b, a, block=block, device=CPU)
    for f in ("al", "f", "g", "h"):
        assert getattr(tp, f).dtype == torch.float32
        assert np.array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
    _, ref = J_IIR(jp, jiir.iir_init(jp, (2,)), jnp.asarray(x), inter_block=form)
    st, got = tiir.iir_apply(tp, tiir.iir_init(tp, (2,), device=CPU), torch.from_numpy(x),
                             inter_block=form)
    assert got.dtype == torch.complex64 and st.s.dtype == torch.complex64
    assert _snr_db(ref, got) > 80
    assert _snr_db(tiir.np_iir_full(b, a, x.astype(np.complex128)), got) > 80


def test_forms_agree_streaming_and_jax_stream_carried_on():
    b, a = sig.butter(3, 0.15)
    p = tiir.make_iir_params(b, a, block=64, device=CPU)
    x = _noise(4096, seed=2)
    st1, y1 = tiir.iir_apply(p, tiir.iir_init(p, device=CPU), torch.from_numpy(x))
    st2, y2 = tiir.iir_apply(p, tiir.iir_init(p, device=CPU), torch.from_numpy(x),
                             inter_block="scan")
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(st1.s.numpy(), st2.s.numpy(), rtol=0, atol=1e-4)
    st, outs = tiir.iir_init(p, device=CPU), []
    for i in range(0, 4096, 1024):
        st, y = tiir.iir_apply(p, st, torch.from_numpy(x[i:i + 1024]))
        outs.append(y)
    assert _snr_db(y1.numpy(), torch.cat(outs)) > 90
    # two blocks in JAX, two in the port from the converted params and state
    jp = jiir.make_iir_params(b, a, block=64)
    jst, ya = J_IIR(jp, jiir.iir_init(jp), jnp.asarray(x[:2048]))
    _, yb = tiir.iir_apply(convert.iir_params_from(jp, device=CPU),
                           convert.iir_state_from(jst, device=CPU), torch.from_numpy(x[2048:]))
    assert _snr_db(y1.numpy(), np.concatenate([np.asarray(ya), yb.numpy()])) > 90


def test_sos_real_input_dc_block_and_errors():
    sos = sig.butter(6, 0.3, output="sos")
    x = _noise(4096, seed=4)
    tp = tiir.make_sos_params(sos, device=CPU)
    _, got = tiir.sos_apply(tp, tiir.sos_init(tp, device=CPU), torch.from_numpy(x))
    jp = jiir.make_sos_params(sos)
    _, ref = J_SOS(jp, jiir.sos_init(jp), jnp.asarray(x))
    assert _snr_db(ref, got) > 80 and _snr_db(sig.sosfilt(sos, x.astype(np.complex128)), got) > 80
    b, a = sig.butter(4, 0.2)
    xr = _noise(2048, seed=5, complex_=False)
    yr = tiir.iir_full(tiir.make_iir_params(b, a, device=CPU), torch.from_numpy(xr))
    assert yr.dtype == torch.float32
    jr = jiir.make_iir_params(b, a)
    assert _snr_db(J_IIR(jr, jiir.iir_init(jr, dtype=jnp.float32), jnp.asarray(xr))[1], yr) > 80
    bd, ad = tiir.dc_block_coeffs(0.995)
    assert all(np.array_equal(u, v) for u, v in zip((bd, ad), jiir.dc_block_coeffs(0.995)))
    xd = (_noise(8192, seed=3) + (2.0 - 1.0j)).astype(np.complex64)
    yd = tiir.iir_full(tiir.make_iir_params(bd, ad, device=CPU), torch.from_numpy(xd)).numpy()
    assert abs(np.mean(yd[2048:])) < 0.02
    with pytest.raises(ValueError):
        tiir.make_iir_params([1.0], [1.0, -1.01], device=CPU)
    p = tiir.make_iir_params(b, a, device=CPU)
    with pytest.raises(ValueError):
        tiir.iir_apply(p, tiir.iir_init(p, device=CPU), torch.zeros(100, dtype=torch.complex64))
    with pytest.raises(ValueError):
        tiir.iir_apply(p, tiir.iir_init(p, device=CPU), torch.zeros(128, dtype=torch.complex64),
                       inter_block="nope")


def _tone(n, f, amp):
    return (amp * np.exp(2j * np.pi * f * np.arange(n))).astype(np.complex64)


def test_agc_matches_jax_settles_and_carries_a_jax_stream_on():
    x = np.stack([np.concatenate([_tone(4096, 0.1, 0.2), _tone(4096, 0.1, 2.0)]),
                  _tone(8192, -0.2, 3.0)])
    tp, jp = tagc.make_agc_params(alpha=0.99, device=CPU), jagc.make_agc_params(alpha=0.99)
    got = tagc.agc_full(tp, torch.from_numpy(x))
    _, ref = J_AGC(jp, jagc.agc_init(jp, (2,)), jnp.asarray(x))
    assert got.dtype == torch.complex64 and _snr_db(ref, got) > 80
    for seg in (got.numpy()[0, 2048:4096], got.numpy()[0, 6144:], got.numpy()[1, 2048:]):
        assert abs(np.sqrt(np.mean(np.abs(seg) ** 2)) - 1.0) < 0.05
    jst, ya = J_AGC(jp, jagc.agc_init(jp, (2,)), jnp.asarray(x[:, :4096]))
    _, yb = tagc.agc_apply(convert.agc_params_from(jp, device=CPU),
                           tagc.AgcState(env=convert.iir_state_from(jst.env, device=CPU)),
                           torch.from_numpy(x[:, 4096:]))
    assert _snr_db(ref, np.concatenate([np.asarray(ya), yb.numpy()], -1)) > 80
    silent = tagc.agc_full(tp, torch.zeros(1024, dtype=torch.complex64))
    assert bool(torch.all(silent == 0))


def _qpsk_cfo(nsym, sps, cfo, seed):
    """A differentially coded QPSK burst at sps, RRC-shaped, offset by cfo."""
    from srcdsp_tpu.chains.psk import diff_encode, make_psk_params
    from srcdsp_tpu.chains.tx import linear_tx_apply, linear_tx_init, make_linear_tx, psk_map
    data = jnp.asarray(np.random.default_rng(seed).integers(0, 4, nsym))
    txp = make_linear_tx(0.0, make_psk_params(0.0, decim=1, sps=sps, order=4).taps, sps=sps)
    _, x = linear_tx_apply(txp, linear_tx_init(txp), psk_map(diff_encode(data, 4), 4))
    x = np.asarray(x)
    return (x * np.exp(2j * np.pi * cfo * np.arange(x.size))).astype(np.complex64)


def test_afc_matches_jax_block_by_block_and_carries_a_jax_stream_on():
    sps = 8
    x = _qpsk_cfo(2048, sps, 0.3 / sps, seed=0)
    tp, jp = tafc.make_afc(1.0 / sps, device=CPU), jafc.make_afc(1.0 / sps)
    assert np.array_equal(tp.upper_taps.numpy(), np.asarray(jp.upper_taps))
    assert np.array_equal(tp.lower_taps.numpy(), np.asarray(jp.lower_taps))
    ts, js = tafc.afc_init(tp, device=CPU), jafc.afc_init(jp)
    blocks = np.split(x, 8)
    for blk in blocks:
        ts, (ty, tf0) = tafc.afc_apply(tp, ts, torch.from_numpy(blk))
        js, (jy, jf0) = J_AFC(jp, js, jnp.asarray(blk))
        assert abs(float(tf0) - float(jf0)) < 1e-6
        assert _snr_db(jy, ty) > 80
    assert abs(float(ts.freq) - 0.3 / sps) < 0.02 / sps
    # half the blocks in JAX, the rest in the port
    js = jafc.afc_init(jp)
    for blk in blocks[:4]:
        js, _ = J_AFC(jp, js, jnp.asarray(blk))
    cs, cp = convert.afc_state_from(js, device=CPU), convert.afc_params_from(jp, device=CPU)
    for blk in blocks[4:]:
        cs, _ = tafc.afc_apply(cp, cs, torch.from_numpy(blk))
    assert abs(float(cs.freq) - float(ts.freq)) < 1e-6


def test_freq_to_word_traced_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    edges = [0.0, -0.0, 1.0, -1.0, 2.0, -2.5, 0.5, -0.5, 1e-9, -1e-9, 2 ** -30, -(2 ** -30),
             1 - 2 ** -24, -(1 - 2 ** -24), 0.9999999, 3.75, -7.125]
    f = np.concatenate([rng.uniform(-4.0, 4.0, 50000), edges]).astype(np.float32)
    got = tword(torch.from_numpy(f))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(jword(jnp.asarray(f))).astype(np.int64))
