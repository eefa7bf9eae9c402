"""Port vs JAX package: the coherent coded modem (``chains/modem``) and the
coded FSK link, end to end at small sizes on the CPU.

Contracts:

- `map_codewords_to_symbols` equal;
- the modem on ``tests/e2e/test_modem.py``'s case (2 channels, 4 codewords
  of the z = 16 dual-diagonal code, QAM16 at sps 2, 13 dB, 4 iterations), fed
  the same planes as JAX `make_coherent_modem(interpret=True)`: every
  syndrome clean, decoded == transmitted codewords, `bits_t` and `ok` equal
  to JAX's;
- `configs.build_coded_modem` at that size (its transmit side the port's
  ``chains.tx``): decoded == transmitted codewords;
- `configs.build_coded_link` at 2 channels x 8 codewords (n = 504, 14 dB,
  K2 + K14 plain versions): info BER 0 and ok fraction 1.0, the bar of
  ``tests/e2e/test_coded_link.py``;
- `configs.build_ldpc` and `configs.build_turbo` at small batches: decoded
  == transmitted where the reference's bench expects it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import modem as jm
from srcdsp_tpu.chains.tx import linear_tx_apply, linear_tx_init, make_linear_tx, qam_map
from srcdsp_tpu.kernels.ldpc_pallas import plan_qc
from srcdsp_tpu.ops.nco import freq_to_word
from srcdsp_tpu.ops.window import root_raised_cosine
from srcdsp_tpu.qcldpc import make_dual_diagonal_base, make_qc_ldpc, qc_encode_dual_diagonal
from srcdsp_tpu_torch import configs, convert
from srcdsp_tpu_torch.chains import modem as tm
from tests.torch_threads import one_torch_thread  # noqa: F401


def _tx_channel(sym, center, taps, sps):
    params = make_linear_tx(center, taps, sps)
    _, x = jax.jit(lambda s, v: linear_tx_apply(params, s, v))(linear_tx_init(params),
                                                                jnp.asarray(sym))
    return np.asarray(x)


def test_map_codewords_equal():
    cw = np.random.default_rng(0).integers(0, 2, (3, 48))
    for order in (4, 16, 64):
        np.testing.assert_array_equal(
            tm.map_codewords_to_symbols(torch.as_tensor(cw), order).numpy(),
            np.asarray(jm.map_codewords_to_symbols(jnp.asarray(cw), order)))
    with pytest.raises(ValueError, match="bits/symbol"):
        tm.map_codewords_to_symbols(torch.zeros(3, 50), 16)


def test_modem_equal_to_jax_and_decodes():
    C, nw, sps, order = 2, 4, 2, 16
    z, mb, nb = 16, 4, 12
    base = make_dual_diagonal_base(mb, nb, z, seed=1)
    code = make_qc_ldpc(base, z)
    plan = plan_qc(base, z)
    n, k = nb * z, (nb - mb) * z
    spc = n // 4
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2, (C * nw, k))
    cw = np.asarray(qc_encode_dual_diagonal(base, z, jnp.asarray(u)))
    idx = np.asarray(jm.map_codewords_to_symbols(jnp.asarray(cw), order)).reshape(C, nw * spc)
    sym = np.asarray(qam_map(jnp.asarray(idx), order))
    taps = root_raised_cosine(sps, 16, beta=0.35)
    centers = [0.08, -0.11]
    out_tile, b_rows = 128, 2
    blk = b_rows * out_tile
    nsym_pad = -(-(nw * spc + len(taps)) // blk) * blk
    pad = np.zeros((C, nsym_pad - nw * spc), np.complex64)
    x = np.stack([_tx_channel(np.concatenate([sym[c], pad[c]]), centers[c], taps, sps)
                  for c in range(C)])
    sigma = 10.0 ** (-13.0 / 20.0) / np.sqrt(2.0)
    x = x + sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    imp = np.zeros(64, np.complex64)
    imp[0] = 1.0
    cas = np.convolve(_tx_channel(imp, 0.0, taps, sps).real, taps)
    g, lag = float(cas.max()), int(cas.argmax()) // sps
    dwords = np.asarray([freq_to_word(-c) for c in centers], np.uint32)
    pipe, hist = jm.make_coherent_modem(taps / g, dwords, sps, order, code, plan, nw=nw, lag=lag,
                                        iters=4, out_tile=out_tile, b_rows=b_rows, b_tile=C * nw,
                                        interpret=True)
    planes = np.zeros((C, 2, hist + nsym_pad * sps), np.float32)
    planes[:, 0, hist:] = x.real
    planes[:, 1, hist:] = x.imag
    jbits, jok = jax.jit(pipe)(jnp.asarray(planes))

    tpipe, thist = tm.make_coherent_modem(taps / g, dwords, sps, order,
                                          convert.ldpc_code_from(code, device="cpu"),
                                          convert.qc_plan_from(plan), nw=nw, lag=lag, iters=4,
                                          out_tile=out_tile, b_rows=b_rows, b_tile=C * nw,
                                          device="cpu")
    assert thist == hist
    bits_t, ok = tpipe(torch.as_tensor(planes))
    assert bool(ok.all())
    np.testing.assert_array_equal(bits_t.numpy().T, cw)
    np.testing.assert_array_equal(bits_t.numpy()[:k].T, u)
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    with pytest.raises(ValueError, match="b_tile"):
        tm.make_coherent_modem(taps / g, dwords, sps, order,
                               convert.ldpc_code_from(code, device="cpu"),
                               convert.qc_plan_from(plan), nw=3, b_tile=8, device="cpu")


def test_build_coded_modem_decodes():
    b = configs.build_coded_modem(channels=2, words=4, iters=4, z=16, out_tile=128, b_rows=2,
                                  b_tile=8, device="cpu")
    bits_t, ok = b.step(*b.example)
    assert bool(ok.all())
    assert torch.equal(bits_t.T, b.meta["cw"])
    assert torch.equal(bits_t[:b.meta["k"]].T, b.meta["u"].to(torch.int32))


def test_build_coded_link_decodes_clean():
    b = configs.build_coded_link(channels=2, words=8, out_tile=128, b_rows=2, device="cpu")
    bits, info, ok = b.step(*b.example)
    assert float(ok.to(torch.float32).mean()) == 1.0
    assert float((info.reshape(b.meta["u"].shape) != b.meta["u"]).to(torch.float32).mean()) == 0.0
    assert torch.equal(bits, b.meta["cw"])
    assert b.meta["raw_ber"] < 0.05


@pytest.mark.parametrize("variant", configs.LDPC_VARIANTS)
def test_build_ldpc_decodes(variant):
    b = configs.build_ldpc(variant, batch=16, iters=4 if variant == "qc" else 10, device="cpu")
    bits, info, ok = b.step(*b.example)
    okn = ok.numpy()
    assert okn.mean() > 0.9
    np.testing.assert_array_equal(bits.numpy()[okn], b.meta["cw"].numpy()[okn])
    with pytest.raises(ValueError, match="variant"):
        configs.build_ldpc("dense", device="cpu")


def test_build_turbo_layouts_agree():
    outs = {}
    for layout in configs.TURBO_LAYOUTS:
        b = configs.build_turbo(t=48, iters=3, batch=8, snr_db=3.0, layout=layout, device="cpu")
        outs[layout] = b.step(*b.example)
        assert float((outs[layout][0] != b.meta["u"]).to(torch.float32).mean()) < 0.01
    assert all(torch.equal(a, c) for a, c in zip(outs["kernel"], outs["batch"]))
    with pytest.raises(ValueError, match="layout"):
        configs.build_turbo(layout="vmap", device="cpu")
