"""Port vs JAX package: the turbo codec (``turbo``) and the BCJR kernel's
plain version and turbo driver (``kernels/bcjr_pallas``, K16).

Contracts, all bit for bit (the reference eager; its Pallas kernel in
interpret mode):

- `make_rsc` tables and `make_turbo`'s interleaver equal; `rsc_encode` and
  `turbo_encode` equal;
- `bcjr_decode` and `bcjr_decode_batch` posteriors and extrinsics equal;
- plain K16 (`make_bcjr_kernel` on the CPU) == JAX `make_bcjr_kernel` at
  t 64 and 67 terminated, 64 and 61 open;
- `turbo_decode_pallas` (port, CPU) == JAX `turbo_decode_pallas` and
  `turbo_decode_batch` == JAX `turbo_decode_batch`: bits and posteriors
  (t 48, B 8, 3 iterations), BER < 1 % at that SNR;
- the kernel builder's ValueErrors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import turbo as jt
from srcdsp_tpu.kernels import bcjr_pallas as jk
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch import turbo as tt
from srcdsp_tpu_torch.kernels import bcjr_pallas as tk
from tests.torch_threads import one_torch_thread  # noqa: F401


def _llrs(shape, seed):
    return (4.0 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_rsc_and_turbo_tables_equal():
    for args in ((), (3, 0o7, 0o5)):
        jc, tc = jt.make_rsc(*args), tt.make_rsc(*args)
        for f in jc._fields:
            np.testing.assert_array_equal(np.asarray(getattr(tc, f)), np.asarray(getattr(jc, f)), f)
    jtc = jt.make_turbo(48, seed=0)
    np.testing.assert_array_equal(tt.make_turbo(48, seed=0).perm, jtc.perm)
    conv = convert.turbo_code_from(jtc)
    np.testing.assert_array_equal(conv.perm, jtc.perm)
    np.testing.assert_array_equal(conv.rsc.prev_parity, jtc.rsc.prev_parity)


@pytest.mark.parametrize("terminate", [True, False])
def test_rsc_encode_equal(terminate):
    code = jt.make_rsc()
    bits = np.random.default_rng(1).integers(0, 2, 40)
    js, jp = jt.rsc_encode(code, jnp.asarray(bits), terminate=terminate)
    ts, tp = tt.rsc_encode(tt.make_rsc(), torch.as_tensor(bits), terminate=terminate)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("t_len,terminated", [(64, True), (67, True), (64, False), (61, False)])
def test_bcjr_and_plain_k16_bitexact(t_len, terminated):
    b = 16
    ls, lp, la = (_llrs((t_len, b), s) for s in range(3))
    jcode, tcode = jt.make_rsc(), tt.make_rsc()
    post_j, ext_j = jt.bcjr_decode_batch(jcode, jnp.asarray(ls), jnp.asarray(lp), jnp.asarray(la),
                                         terminated=terminated)
    post_t, ext_t = tt.bcjr_decode_batch(tcode, torch.as_tensor(ls), torch.as_tensor(lp),
                                         torch.as_tensor(la), terminated=terminated)
    np.testing.assert_array_equal(post_t.numpy(), np.asarray(post_j))
    np.testing.assert_array_equal(ext_t.numpy(), np.asarray(ext_j))
    kj = jk.make_bcjr_kernel(jcode, t_len, terminated, b_tile=b, interpret=True)(
        jnp.asarray(ls + la), jnp.asarray(lp))
    kt = tk.make_bcjr_kernel(tcode, t_len, terminated, b_tile=b, device="cpu")(
        torch.as_tensor(ls + la), torch.as_tensor(lp))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(post_j))
    one_j = jt.bcjr_decode(jcode, jnp.asarray(ls[:, 3]), jnp.asarray(lp[:, 3]),
                           jnp.asarray(la[:, 3]), terminated=terminated)
    one_t = tt.bcjr_decode(tcode, torch.as_tensor(ls[:, 3]), torch.as_tensor(lp[:, 3]),
                           torch.as_tensor(la[:, 3]), terminated=terminated)
    for a, c in zip(one_j, one_t):
        np.testing.assert_array_equal(c.numpy(), np.asarray(a))


@pytest.fixture(scope="module")
def turbo_case():
    t, b = 48, 8
    tc = jt.make_turbo(t, seed=0)
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2, (b, t))
    streams = jax.vmap(lambda x: jt.turbo_encode(tc, x))(jnp.asarray(u))
    sigma = 0.8
    llrs = [(2.0 / sigma ** 2 * ((1.0 - 2.0 * np.asarray(s)) + sigma * rng.standard_normal(s.shape))
             ).astype(np.float32) for s in streams]
    return tc, u, streams, llrs


def test_turbo_encode_equal(turbo_case):
    tc, u, streams, _ = turbo_case
    got = tt.turbo_encode(tt.make_turbo(48, seed=0), torch.as_tensor(u))
    for a, c in zip(streams, got):
        np.testing.assert_array_equal(c.numpy(), np.asarray(a))


def test_turbo_pallas_and_batch_bitexact(turbo_case):
    tc, u, _, llrs = turbo_case
    ttc = convert.turbo_code_from(tc)
    jb, jp = jk.turbo_decode_pallas(tc, *map(jnp.asarray, llrs), iters=3, b_tile=8,
                                    interpret=True)
    tb, tp = tk.turbo_decode_pallas(ttc, *map(torch.as_tensor, llrs), iters=3, b_tile=8)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    bb, bp = tt.turbo_decode_batch(ttc, *map(torch.as_tensor, llrs), iters=3)
    jbb, jbp = jt.turbo_decode_batch(tc, *map(jnp.asarray, llrs), iters=3)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(jbp))
    assert torch.equal(bb, tb) and torch.equal(bp, tp)
    assert float((tb.numpy() != u).mean()) < 0.01
    one_b, one_p = tt.turbo_decode(ttc, *(torch.as_tensor(x[2]) for x in llrs), iters=3)
    assert torch.equal(one_b, tb[2]) and torch.equal(one_p, tp[2])


def test_bcjr_kernel_value_errors():
    with pytest.raises(ValueError, match="8-state"):
        tk.make_bcjr_kernel(tt.make_rsc(3, 0o7, 0o5), 16, True, device="cpu")
    with pytest.raises(ValueError, match="current bit"):
        tk.make_bcjr_kernel(tt.make_rsc(4, 0o13, 0o5), 16, True, device="cpu")
    fn = tk.make_bcjr_kernel(tt.make_rsc(), 16, True, b_tile=8, device="cpu")
    with pytest.raises(ValueError, match="b_tile=8"):
        fn(torch.zeros(16, 12), torch.zeros(16, 12))
    with pytest.raises(ValueError, match="t_len=16"):
        fn(torch.zeros(15, 8), torch.zeros(15, 8))
    with pytest.raises(ValueError, match="float32"):
        fn(torch.zeros(16, 8, dtype=torch.float64), torch.zeros(16, 8))
    with pytest.raises(ValueError, match="lp"):
        fn(torch.zeros(16, 8), torch.zeros(16, 16))
