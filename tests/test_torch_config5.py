"""Port vs JAX package: config 5 (the polyphase channelizer + per-channel QPSK
demod) as a whole.

Contracts:

- ``configs.build_config5(frames=512, num_channels=8)`` against the JAX
  preset on the same seed-0 input: soft symbols to rel L2 < 1e-4, indices
  agreeing on at least 99.9 % (the input is noise: a symbol on a decision
  boundary may fall either way under float32 rounding);
- every ``build_config5_onchip`` variant at M = 8 on the CPU (the kernels'
  plain versions): finite outputs of the bench's shapes, and SER 0 on every
  channel of a modulated wideband after ``diff_decode``; ``fused`` and
  ``fused_std`` decide the same indices there;
- a stream started by the JAX PSK chain continues in the port with no seam:
  ``convert.psk_state_from`` carries the state; the next block's indices
  equal JAX's next block and the port's own two-block run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import configs as jconfigs
from srcdsp_tpu.chains import psk as jp
from srcdsp_tpu_torch import configs, convert
from srcdsp_tpu_torch.chains import psk as tp
from srcdsp_tpu_torch.kernels.bank_pallas import phase_major
from srcdsp_tpu_torch.testing.signals import psk_wideband

from test_torch_psk import _tx, ser_diff
from tests.torch_threads import one_torch_thread  # noqa: F401

M = 8


def test_build_config5_matches_jax():
    b = configs.build_config5(frames=512, num_channels=M, device="cpu")
    jb_ = jconfigs.build_config5(frames=512, num_channels=M)
    np.testing.assert_array_equal(b.example[0].numpy(), np.asarray(jb_.example[0]))
    assert b.samples_per_call == jb_.samples_per_call == 512 * M
    idx, soft = b.step(*b.example)
    jidx, jsoft = jb_.step(*jb_.example)
    jidx, jsoft = np.asarray(jidx), np.asarray(jsoft)
    assert tuple(idx.shape) == jidx.shape == (M, 128)
    assert np.linalg.norm(soft.numpy() - jsoft) / np.linalg.norm(jsoft) < 1e-4
    assert np.mean(idx.numpy() == jidx) >= 0.999


@pytest.fixture(scope="module")
def modulated():
    data, _, wb = psk_wideband(np.random.default_rng(5), M, 512, 4, 4, device="cpu")
    return data, wb


@pytest.mark.parametrize("variant", configs.CONFIG5_ONCHIP)
def test_onchip_variants_shapes_and_ser(modulated, variant):
    data, wb = modulated
    b = configs.build_config5_onchip(frames=2048, variant=variant, num_channels=M, b_k=128,
                                     device="cpu")
    assert b.samples_per_call == 2048 * M
    acc, (idx, (sr, si)) = b.step(*b.example)
    assert tuple(idx.shape) == (M, 512) and idx.dtype == torch.int32
    assert bool(torch.isfinite(sr).all() and torch.isfinite(si).all())
    assert len(acc) == 4 and all(tuple(a.shape) == (M, 1) for a in acc)
    k = wb.shape[-1] // M
    if variant == "planes":
        out = b.step(wb.real.contiguous(), wb.imag.contiguous())
    else:
        hc = b.meta["hist_cols"]
        assert tuple(b.example[0].shape) == (2, M, hc + 2048)
        flat = torch.cat([torch.zeros((2, hc * M)), torch.stack([wb.real, wb.imag])], dim=-1)
        out = b.step(phase_major(flat, M, hc))
    idx = out[1][0]
    assert tuple(idx.shape) == (M, k // 4)
    for c in range(M):
        assert ser_diff(data[c], idx[c].numpy(), 4, settle=30, lags=32) == 0.0, (variant, c)


def test_fused_and_fused_std_agree(modulated):
    _, wb = modulated
    outs = {}
    for variant in ("fused", "fused_std"):
        b = configs.build_config5_onchip(frames=2048, variant=variant, num_channels=M, b_k=128,
                                         device="cpu")
        hc = b.meta["hist_cols"]
        flat = torch.cat([torch.zeros((2, hc * M)), torch.stack([wb.real, wb.imag])], dim=-1)
        outs[variant] = b.step(phase_major(flat, M, hc))[1][0]
    assert torch.equal(outs["fused"], outs["fused_std"])


def test_onchip_rejects_bad_variant_and_size():
    with pytest.raises(ValueError, match="variant"):
        configs.build_config5_onchip(frames=1024, variant="xla", num_channels=M, device="cpu")
    with pytest.raises(ValueError, match="b_k"):
        configs.build_config5_onchip(frames=64, variant="bank", num_channels=M, b_k=128,
                                     device="cpu")


def test_psk_state_from_jax_continues_with_no_seam():
    order, decim, sps = 4, 2, 4
    data, params, x = _tx(12, 512, order, decim, sps, 0.17, channel_shape=(2,))
    half = x.shape[-1] // 2
    jpar = jp.make_psk_params(0.17, decim=decim, sps=sps, order=order)
    jst, _ = jp.psk_apply(jpar, jp.psk_init(jpar, (2,)), jnp.asarray(x[:, :half]))
    _, (ji2, js2) = jp.psk_apply(jpar, jst, jnp.asarray(x[:, half:]))
    tpar = convert.psk_params_from(jpar, device="cpu")
    assert tpar.taps.dtype == torch.float32 and int(tpar.freq_word) == int(np.asarray(jpar.freq_word))
    st = convert.psk_state_from(jst, device="cpu")
    _, (ti2, ts2) = tp.psk_apply(tpar, st, torch.from_numpy(x[:, half:]))
    np.testing.assert_array_equal(ti2.numpy(), np.asarray(ji2))
    js2 = np.asarray(js2)
    assert np.linalg.norm(ts2.numpy() - js2) / np.linalg.norm(js2) < 1e-4
    own, _ = tp.psk_apply(tpar, tp.psk_init(tpar, (2,)), torch.from_numpy(x[:, :half]))
    _, (oi2, _) = tp.psk_apply(tpar, own, torch.from_numpy(x[:, half:]))
    assert torch.equal(oi2, ti2)
    for c in range(2):
        full = torch.cat([tp.psk_apply(tpar, tp.psk_init(tpar, (2,)),
                                       torch.from_numpy(x[:, :half]))[1][0][c], ti2[c]])
        assert ser_diff(data[c], full.numpy(), order) < 0.01
