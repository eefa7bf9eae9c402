"""Port vs JAX package: the decimation tier, ``ops/halfband``, ``ops/cic``,
``ops/decimplan`` and ``ops/ddc``, on the same numpy inputs (the JAX unit
tests' own shapes).

Contracts, each stated where it is checked:

- half-band, plan and DDC outputs against JAX: atol 1e-5, the reference's own
  bound between its half-band split and the full-rate FIR (float32 sums in
  another order); streaming against one shot in the port: atol 3e-6, the
  reference's DDC bound (tests/unit/test_ddc.py);
- CIC in int32: equal by ``np.array_equal``, including a stream whose
  integrators pass 2^31 (order 4 and 5, rate 16, full-scale input);
- designs (half-band taps, plans) bit-equal;
- a stream begun in JAX and carried on in the port through ``convert``:
  bit-equal for CIC, atol 1e-5 against the JAX one-shot otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.ops import cic as jcic
from srcdsp_tpu.ops import ddc as jddc
from srcdsp_tpu.ops import decimplan as jdp
from srcdsp_tpu.ops import halfband as jhb
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.ops import cic as tcic
from srcdsp_tpu_torch.ops import ddc as tddc
from srcdsp_tpu_torch.ops import decimplan as tdp
from srcdsp_tpu_torch.ops import halfband as thb
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, ref, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)


# ---------- half-band ----------

@pytest.mark.parametrize("t", [7, 11, 31, 63])
def test_design_halfband_bit_equal(t):
    got, ref = thb.design_halfband(t), jhb.design_halfband(t)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("t,shape", [(31, (4096,)), (19, (2, 1024))])
def test_halfband_decim_matches_jax(t, shape):
    h = thb.design_halfband(t)
    x = _noise(shape, seed=t)
    ch = shape[:-1]
    _, ref = jhb.halfband_decim(h, jhb.halfband_init(h, ch), jnp.asarray(x))
    st, got = thb.halfband_decim(h, thb.halfband_init(h, ch, device=CPU), torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == ref.shape
    _close(got, ref)
    _close(got, np.stack([thb.np_halfband_decim(h, r.astype(np.complex128))
                          for r in x.reshape(-1, shape[-1])]).reshape(ref.shape))


def test_halfband_cascade_streaming_and_jax_stream_carried_on():
    stages = [thb.design_halfband(23), thb.design_halfband(11)]
    x = _noise(4096, seed=3)
    _, one = thb.cascade_apply(stages, thb.cascade_init(stages, device=CPU), torch.from_numpy(x))
    _, jone = jhb.cascade_apply(stages, jhb.cascade_init(stages), jnp.asarray(x))
    _close(one, jone)
    sts, outs = thb.cascade_init(stages, device=CPU), []
    for blk in np.split(x, 4):
        sts, y = thb.cascade_apply(stages, sts, torch.from_numpy(blk))
        outs.append(y)
    _close(torch.cat(outs), one, atol=3e-6)
    # the first half in JAX, the rest in the port
    jst, ya = jhb.cascade_apply(stages, jhb.cascade_init(stages), jnp.asarray(x[:2048]))
    tst = tuple(convert.halfband_state_from(s, device=CPU) for s in jst)
    _, yb = thb.cascade_apply(stages, tst, torch.from_numpy(x[2048:]))
    _close(np.concatenate([np.asarray(ya), yb.numpy()]), jone)


# ---------- CIC ----------

@pytest.mark.parametrize("rate,order,delay", [(4, 3, 1), (8, 4, 1), (5, 2, 2), (16, 5, 1)])
def test_cic_decim_int32_equals_jax_and_twin(rate, order, delay):
    x = np.random.default_rng(0).integers(-32768, 32768, 4 * 64 * rate).astype(np.int32)
    _, ref = jcic.cic_decim_apply(jcic.cic_decim_init(order, delay), jnp.asarray(x), rate)
    _, got = tcic.cic_decim_apply(tcic.cic_decim_init(order, delay, device=CPU),
                                  torch.from_numpy(x), rate)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got.numpy(), tcic.np_cic_decim(x, rate, order, delay))


@pytest.mark.parametrize("order", [4, 5])
def test_cic_int32_wraps_past_2_31_as_jax(order):
    """Full-scale input through rate 16: the integrators pass 2^31 and wrap."""
    rate = 16
    x = np.full(256 * rate, 32767, np.int32)
    x[1::3] = -32768
    jst, ref = jcic.cic_decim_apply(jcic.cic_decim_init(order), jnp.asarray(x), rate)
    tst, got = tcic.cic_decim_apply(tcic.cic_decim_init(order, device=CPU), torch.from_numpy(x),
                                    rate)
    # the integrators did overflow int32 (the int64 sum would differ)
    wide = np.cumsum(x.astype(np.int64))
    for _ in range(order - 1):
        wide = np.cumsum(wide)
    assert np.abs(wide).max() > 2 ** 31
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(tst.integ.numpy(), np.asarray(jst.integ))
    assert np.array_equal(tst.combs.numpy(), np.asarray(jst.combs))


def test_cic_streaming_and_jax_stream_carried_on_bit_exact():
    rate, order = 8, 4
    x = np.random.default_rng(1).integers(-32768, 32768, (3, 8 * 128)).astype(np.int32)
    one = tcic.np_cic_decim(x, rate, order)
    st, outs = tcic.cic_decim_init(order, channel_shape=(3,), device=CPU), []
    for blk in np.split(x, 8, axis=-1):
        st, y = tcic.cic_decim_apply(st, torch.from_numpy(blk), rate)
        outs.append(y.numpy())
    assert np.array_equal(np.concatenate(outs, -1), one)
    jst, ya = jcic.cic_decim_apply(jcic.cic_decim_init(order, channel_shape=(3,)),
                                   jnp.asarray(x[:, :512]), rate)
    _, yb = tcic.cic_decim_apply(convert.cic_state_from(jst, device=CPU),
                                 torch.from_numpy(x[:, 512:]), rate)
    assert np.array_equal(np.concatenate([np.asarray(ya), yb.numpy()], -1), one)


def test_cic_interp_and_float_path_as_jax():
    x = np.random.default_rng(2).integers(-1000, 1000, 256).astype(np.int32)
    _, ref = jcic.cic_interp_apply(jcic.cic_interp_init(3), jnp.asarray(x), 4)
    st, outs = tcic.cic_interp_init(3, device=CPU), []
    for blk in np.split(x, 4):
        st, y = tcic.cic_interp_apply(st, torch.from_numpy(blk), 4)
        outs.append(y.numpy())
    assert np.array_equal(np.concatenate(outs), np.asarray(ref))
    xf = np.random.default_rng(4).standard_normal(64 * 4).astype(np.float32)
    _, rf = jcic.cic_decim_apply(jcic.cic_decim_init(2, dtype=jnp.float32), jnp.asarray(xf), 4)
    _, gf = tcic.cic_decim_apply(tcic.cic_decim_init(2, dtype=torch.float32, device=CPU),
                                 torch.from_numpy(xf), 4)
    assert gf.dtype == torch.float32
    np.testing.assert_allclose(gf.numpy(), np.asarray(rf), rtol=1e-5, atol=1e-4)
    assert tcic.cic_gain(8, 3, 2) == jcic.cic_gain(8, 3, 2)
    assert np.array_equal(tcic.cic_compensator(129, 8, 4, cutoff=0.2),
                          jcic.cic_compensator(129, 8, 4, cutoff=0.2))


# ---------- multistage plan ----------

@pytest.mark.parametrize("decim,passband,atten", [(48, 0.008, 70.0), (16, 0.02, 60.0),
                                                  (12, 0.01, 70.0)])
def test_plan_bit_equal(decim, passband, atten):
    got, ref = tdp.plan_decimation(decim, passband, atten), jdp.plan_decimation(decim, passband,
                                                                                atten)
    assert len(got.halfband_taps) == len(ref.halfband_taps)
    assert all(np.array_equal(a, b) for a, b in zip(got.halfband_taps, ref.halfband_taps))
    assert (got.final_taps is None) == (ref.final_taps is None)
    if ref.final_taps is not None:
        assert got.final_taps.dtype == np.float32
        assert np.array_equal(got.final_taps, ref.final_taps)
    assert got[2:] == ref[2:]
    assert np.array_equal(tdp.plan_response(got, 1024)[1], jdp.plan_response(ref, 1024)[1])
    assert tdp.single_stage_taps(decim, passband, atten) == jdp.single_stage_taps(
        decim, passband, atten)


def test_plan_apply_matches_jax_and_streams():
    plan = tdp.plan_decimation(24, passband=0.012, atten_db=60.0)
    x = _noise((2, 24 * 1024), seed=0)
    _, ref = jdp.decim_plan_apply(plan, jdp.decim_plan_init(plan, (2,)), jnp.asarray(x))
    _, one = tdp.decim_plan_apply(plan, tdp.decim_plan_init(plan, (2,), device=CPU),
                                  torch.from_numpy(x))
    assert one.shape == ref.shape and one.dtype == torch.complex64
    _close(one, ref)
    st, outs = tdp.decim_plan_init(plan, (2,), device=CPU), []
    for blk in np.split(x, 4, axis=-1):
        st, y = tdp.decim_plan_apply(plan, st, torch.from_numpy(blk))
        outs.append(y)
    _close(torch.cat(outs, -1), one, atol=3e-6)


def test_plan_errors_as_jax():
    for args in ((1, 0.01), (8, 0.07), (8, 0.0)):
        with pytest.raises(ValueError):
            jdp.plan_decimation(*args)
        with pytest.raises(ValueError):
            tdp.plan_decimation(*args)


# ---------- DDC ----------

def test_ddc_params_equal_jax():
    got, ref = tddc.make_ddc(0.21, 0.004, atten_db=70.0), jddc.make_ddc(0.21, 0.004, 70.0)
    assert got.decim == ref.decim >= 64
    assert int(got.freq_word) == int(np.asarray(ref.freq_word))
    conv = convert.ddc_params_from(ref)
    assert conv.decim == got.decim and int(conv.freq_word) == int(got.freq_word)
    assert all(np.array_equal(a, b) for a, b in zip(conv.plan.halfband_taps,
                                                      got.plan.halfband_taps))
    assert np.array_equal(conv.plan.final_taps, got.plan.final_taps)
    for bw in (0.6, 0.45):
        with pytest.raises(ValueError):
            tddc.make_ddc(0.1, bw)


def test_ddc_matches_jax_streams_and_carries_a_jax_stream_on():
    ddc = tddc.make_ddc(center=-0.1, bandwidth=0.01)
    jp = jddc.make_ddc(center=-0.1, bandwidth=0.01)
    n = ddc.decim * 1024
    x = _noise(n, seed=0)
    _, ref = jddc.ddc_apply(jp, jddc.ddc_init(jp), jnp.asarray(x))
    _, one = tddc.ddc_apply(ddc, tddc.ddc_init(ddc, device=CPU), torch.from_numpy(x))
    _close(one, ref)
    st, outs = tddc.ddc_init(ddc, device=CPU), []
    for blk in np.split(x, 4):
        st, y = tddc.ddc_apply(ddc, st, torch.from_numpy(blk))
        outs.append(y)
    _close(torch.cat(outs), one, atol=3e-6)
    # half in JAX, the rest in the port from the converted state and params
    jst, ya = jddc.ddc_apply(jp, jddc.ddc_init(jp), jnp.asarray(x[:n // 2]))
    _, yb = tddc.ddc_apply(convert.ddc_params_from(jp), convert.ddc_state_from(jst, device=CPU),
                           torch.from_numpy(x[n // 2:]))
    _close(np.concatenate([np.asarray(ya), yb.numpy()]), ref)


def test_ddc_tone_in_band_kept_neighbour_removed():
    """The reference's DDC check (tests/unit/test_ddc.py) on the port: the
    in-band tone's amplitude within 5 %, the residual below -55 dB."""
    ddc = tddc.make_ddc(center=0.21, bandwidth=0.004, atten_db=70.0)
    n = ddc.decim * 4096
    k = np.arange(n)
    x = (np.exp(2j * np.pi * (0.21 + 0.0012) * k)
         + 0.9 * np.exp(2j * np.pi * (0.21 + 0.02) * k)).astype(np.complex64)
    _, y = tddc.ddc_apply(ddc, tddc.ddc_init(ddc, device=CPU), torch.from_numpy(x))
    y = y.numpy().astype(np.complex128)[256:]
    f_in = 0.0012 * ddc.decim
    a_in = abs(np.mean(y * np.exp(-2j * np.pi * f_in * np.arange(y.size))))
    assert abs(a_in - 1.0) < 0.05
    p_resid = np.mean(np.abs(y) ** 2) - a_in ** 2
    assert 10 * np.log10(max(p_resid, 1e-30) / 0.81) < -55.0
