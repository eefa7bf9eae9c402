"""Port vs JAX package: `ops/dpd` (memory-polynomial basis, PA models,
predistorter apply and the indirect-learning fit).

Fixtures: the reference test's band-limited Gaussian drives (JAX-drawn,
scale 0.6 and 0.18), its order-5 / memory-3 PA and Saleh's PA. The JAX side
runs once per module.

Contracts:

- bit for bit: `mp_basis` (elementwise products in the same order), the
  block-wise `dpd_apply` against the one-shot run under any split
  (`torch.equal`: the apply sums the basis columns in a fixed order, so a
  row's output does not depend on the block), a JAX DpdState handed over
  mid-stream (`convert.dpd_state_from`) against the port's own stream;
- rel L2 <= 1e-5: the PA models, the predistorted output for the same
  coefficients, `lin_gain_ls`;
- the fitted coefficients within rel L2 2e-2 of the JAX fit: a solve of the
  ridge-regularised normal equations, whose float32 Gram (condition number
  2.1e5 on the memory PA's basis) torch and XLA round differently, so both
  sit about 3e-3 from the float64 solve; measured 1.9e-3 (one fit), 9.3e-3
  (three ILA iterations, each refit driven by the last) and 3.1e-4 (Saleh,
  order 7); the linear gain within 1e-5; the linearized NMSE within 0.2 dB
  of the JAX package's (measured 0.056 dB: -64.67 against -64.61) and the
  reference test's gain (> 20 dB, below -55 dB).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.ops import dpd as jdpd
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.ops import dpd as tdpd
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
ORDER, MEM = 5, 3
PA_COEFFS = np.array(
    [1.0 + 0.0j, 0.06 - 0.02j, -0.01 + 0.01j,
     -0.08 + 0.03j, 0.02 + 0.01j, 0.0 - 0.005j,
     0.012 - 0.004j, -0.004j, 0.001 + 0.0j], np.complex64)


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _signal(seed, n, scale=0.6):
    """The reference test's drive: band-limited Gaussian, JAX-drawn."""
    xr = jax.random.normal(jax.random.PRNGKey(seed), (2, n + 64))
    x = (xr[0] + 1j * xr[1]).astype(jnp.complex64)
    taps = jnp.asarray(np.hamming(33) / np.sum(np.hamming(33)), jnp.complex64)
    x = jnp.convolve(x, taps, mode="valid")[:n]
    return np.array(scale * x / jnp.sqrt(jnp.mean(jnp.abs(x) ** 2)))


def _nmse_db(ref, y):
    ref, y = np.asarray(ref), np.asarray(y)
    return 10.0 * np.log10(np.mean(np.abs(y - ref) ** 2) / np.mean(np.abs(ref) ** 2))


def _pa_j(x):
    return jdpd.pa_memory_polynomial(jnp.asarray(PA_COEFFS), ORDER, MEM, x)


def _pa_t(x):
    return tdpd.pa_memory_polynomial(PA_COEFFS, ORDER, MEM, x)


@pytest.fixture(scope="module")
def ila():
    x = _signal(2, 4096)
    params, g = jdpd.dpd_train_ila(_pa_j, jnp.asarray(x), ORDER, MEM, iters=3)
    once = jdpd.dpd_identify_ila(jnp.asarray(x), _pa_j(jnp.asarray(x)), ORDER, MEM, 1.0 + 0.0j)
    xs = _signal(3, 4096, scale=0.18)
    sparams, sg = jdpd.dpd_train_ila(jdpd.pa_saleh, jnp.asarray(xs), 7, 1, iters=3)
    lin = _nmse_db(g * x, _pa_j(jdpd.dpd_full(params, jnp.asarray(x))))
    st = jdpd.dpd_init(params)
    st, _ = jdpd.dpd_apply(params, st, jnp.asarray(x[:300]))
    return dict(x=x, params=params, g=complex(g), once=np.asarray(once), xs=xs,
                sparams=sparams, sg=complex(sg), lin=lin,
                full=np.asarray(jdpd.dpd_full(params, jnp.asarray(x))), state300=st,
                basis=np.asarray(jdpd.mp_basis(jnp.asarray(x[:512]), ORDER, MEM)),
                basis_h=np.asarray(jdpd.mp_basis(jnp.asarray(x[512:1024]), 7, 4,
                                                 history=jnp.asarray(x[509:512]))))


def test_basis_bit_for_bit(ila):
    x = ila["x"]
    b = tdpd.mp_basis(x[:512], ORDER, MEM, device=CPU)
    assert b.shape == (512, tdpd.mp_num_coeffs(ORDER, MEM)) == (512, 9)
    np.testing.assert_array_equal(b.numpy(), ila["basis"])
    b = tdpd.mp_basis(torch.as_tensor(x[512:1024]), 7, 4, history=torch.as_tensor(x[509:512]))
    np.testing.assert_array_equal(b.numpy(), ila["basis_h"])


def test_pa_models(ila):
    x = ila["x"][:2048]
    assert rel(_pa_t(torch.as_tensor(x)).numpy(), np.asarray(_pa_j(jnp.asarray(x)))) <= 1e-5
    assert rel(tdpd.pa_saleh(x, device=CPU).numpy(), np.asarray(jdpd.pa_saleh(jnp.asarray(x)))) <= 1e-5
    r = torch.linspace(0.05, 1.5, 32).to(torch.complex64)
    g = (tdpd.pa_saleh(r).abs() / r.abs()).numpy()
    assert g[0] > g[-1] * 1.5


def test_identity_and_validation():
    x = _signal(1, 256)
    y = tdpd.dpd_full(tdpd.make_dpd_params(ORDER, MEM, device=CPU), x)
    np.testing.assert_array_equal(y.numpy(), x)
    for args in ((4, 2), (3, 0)):
        with pytest.raises(ValueError):
            tdpd.make_dpd_params(*args, device=CPU)
    with pytest.raises(ValueError, match="coeffs"):
        tdpd.make_dpd_params(3, 2, coeffs=np.zeros(5, np.complex64), device=CPU)


def test_params_and_apply_equal_for_jax_coefficients(ila):
    p = convert.dpd_params_from(ila["params"], device=CPU)
    np.testing.assert_array_equal(p.coeffs.numpy(), np.asarray(ila["params"].coeffs))
    assert (p.order, p.memory) == (ORDER, MEM)
    y = tdpd.dpd_full(p, torch.as_tensor(ila["x"]))
    assert rel(y.numpy(), ila["full"]) <= 1e-5


@pytest.mark.parametrize("splits", [[128, 384, 640], [1, 2, 3, 1000, 4095], [2048]])
def test_streaming_equals_one_shot_bit_for_bit(ila, splits):
    p = convert.dpd_params_from(ila["params"], device=CPU)
    x = torch.as_tensor(ila["x"])
    whole = tdpd.dpd_full(p, x)
    st, outs = tdpd.dpd_init(p), []
    for blk in torch.tensor_split(x, splits):
        st, y = tdpd.dpd_apply(p, st, blk)
        outs.append(y)
    assert torch.equal(torch.cat(outs), whole)
    xs = torch.stack([x[:1024], 2 * x[1024:2048], x[2048:3072]])
    batched = tdpd.dpd_full(p, xs)
    for i in range(3):
        assert torch.equal(batched[i], tdpd.dpd_full(p, xs[i]))


def test_jax_state_hand_over(ila):
    p = convert.dpd_params_from(ila["params"], device=CPU)
    st = convert.dpd_state_from(ila["state300"], device=CPU)
    np.testing.assert_array_equal(st.history.numpy(), ila["x"][298:300])
    _, tail = tdpd.dpd_apply(p, st, ila["x"][300:])
    _, whole = tdpd.dpd_apply(p, tdpd.dpd_init(p), ila["x"])
    assert torch.equal(tail, whole[300:])


def test_identify_and_train(ila):
    x = ila["x"]
    once = tdpd.dpd_identify_ila(x, _pa_t(torch.as_tensor(x)), ORDER, MEM, 1.0 + 0.0j, device=CPU)
    assert rel(once.numpy(), ila["once"]) <= 2e-2
    g0 = tdpd.lin_gain_ls(x, _pa_t(torch.as_tensor(x)), device=CPU)
    g0_j = complex(jdpd.lin_gain_ls(jnp.asarray(x), _pa_j(jnp.asarray(x))))
    assert abs(complex(g0) - g0_j) <= 1e-5 * abs(g0_j)
    params, g = tdpd.dpd_train_ila(_pa_t, x, ORDER, MEM, iters=3, device=CPU)
    assert abs(complex(g) - ila["g"]) <= 1e-5 * abs(ila["g"])
    assert rel(params.coeffs.numpy(), np.asarray(ila["params"].coeffs)) <= 2e-2
    raw = _nmse_db(g0.numpy() * x, _pa_t(torch.as_tensor(x)).numpy())
    lin = _nmse_db(g.numpy() * x, _pa_t(tdpd.dpd_full(params, torch.as_tensor(x))).numpy())
    assert abs(lin - ila["lin"]) <= 0.2
    assert raw > -35.0 and lin < raw - 20.0 and lin < -55.0


def test_train_saleh(ila):
    xs = ila["xs"]
    params, g = tdpd.dpd_train_ila(lambda z: tdpd.pa_saleh(z), xs, order=7, memory=1, iters=3,
                                   device=CPU)
    assert abs(complex(g) - ila["sg"]) <= 1e-5 * abs(ila["sg"])
    assert rel(params.coeffs.numpy(), np.asarray(ila["sparams"].coeffs)) <= 2e-2
    pa = tdpd.pa_saleh
    raw = _nmse_db((tdpd.lin_gain_ls(xs, pa(xs, device=CPU), device=CPU) * torch.as_tensor(xs)).numpy(),
                   pa(xs, device=CPU).numpy())
    lin = _nmse_db((g * torch.as_tensor(xs)).numpy(), pa(tdpd.dpd_full(params, xs)).numpy())
    assert lin < raw - 25.0
