"""K16's CUDA schedule (``csrc/bcjr.cu``) in torch, held to the reference.

`kernels/bcjr_pallas.bcjr_schedule` runs the kernel's schedule on the CPU:
the trellis from two masks (`trellis_masks`), the static pair selects in
place of gathers, the forward and backward recursions storing their
un-normalized metrics, and every step's posterior from the two stored
histories. It must equal the port's `bcjr_decode_batch` bit for bit
(torch.equal) for three codes, t in {1, 2, 7, 61, 515}, terminated and open,
and the JAX package's Pallas kernel in interpret mode at t <= 61. The masks must rebuild the tables of every k = 4
code that `make_bcjr_kernel` accepts; a code off that trellis is refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import turbo as jt
from srcdsp_tpu.kernels import bcjr_pallas as jk
from srcdsp_tpu_torch import turbo as tt
from srcdsp_tpu_torch.kernels import bcjr_pallas as tk
from tests.torch_threads import one_torch_thread  # noqa: F401

CODES = [(0o13, 0o15), (0o15, 0o17), (0o17, 0o13)]
B = 10   # not a multiple of 32: the kernel's last block has idle lanes


def _llrs(t_len, seed):
    rng = np.random.default_rng(seed)
    return tuple((4.0 * rng.standard_normal((t_len, B))).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("t_len", [1, 2, 7, 61, 515])
@pytest.mark.parametrize("fb,g", CODES)
def test_schedule_equals_bcjr_decode_batch(fb, g, t_len, terminated):
    code = tt.make_rsc(4, fb, g)
    ls, lp = (torch.from_numpy(a) for a in _llrs(t_len, t_len + fb))
    post = tk.bcjr_schedule(*tk.trellis_masks(code), ls, lp, terminated)
    assert torch.equal(post, tt.bcjr_decode_batch(code, ls, lp, terminated=terminated)[0])
    # and the kernel's wrapper on the CPU (the plain version)
    fn = tk.make_bcjr_kernel(code, t_len, terminated, b_tile=B, device="cpu")
    assert torch.equal(fn(ls, lp), post)


@pytest.mark.parametrize("t_len,terminated", [(1, True), (7, False), (61, True), (61, False)])
@pytest.mark.parametrize("fb,g", CODES)
def test_schedule_equals_jax_kernel_interpret(fb, g, t_len, terminated):
    ls, lp = _llrs(t_len, 7 * t_len + g)
    ref = jk.make_bcjr_kernel(jt.make_rsc(4, fb, g), t_len, terminated, b_tile=B,
                              interpret=True)(jnp.asarray(ls), jnp.asarray(lp))
    code = tt.make_rsc(4, fb, g)
    post = tk.bcjr_schedule(*tk.trellis_masks(code), torch.from_numpy(ls), torch.from_numpy(lp),
                            terminated)
    np.testing.assert_array_equal(post.numpy(), np.asarray(ref))


def test_masks_rebuild_every_accepted_code():
    """Every k = 4 code (fb, g < 16) that make_bcjr_kernel accepts is rebuilt
    by its two masks; it refuses the others, and those are exactly the codes
    whose forward polynomial misses the current bit or whose feedback misses
    the last register."""
    accepted = 0
    for fb in range(16):
        for g in range(16):
            code = tt.make_rsc(4, fb, g)
            on_form = bool(g & 8) and bool(fb & 1)
            try:
                tk.make_bcjr_kernel(code, 8, True, device="cpu")
            except ValueError:
                assert not on_form, (fb, g)
                continue
            assert on_form, (fb, g)
            accepted += 1
            nxt, prev, par = tk.masks_trellis(*tk.trellis_masks(code))
            np.testing.assert_array_equal(nxt, code.next_state)
            np.testing.assert_array_equal(prev, code.prev_state)
            np.testing.assert_array_equal(par, code.parity)
    assert accepted == 64


def test_builder_refuses_a_code_off_the_trellis():
    with pytest.raises(ValueError, match="trellis"):
        tk.make_bcjr_kernel(tt.make_rsc(4, 0o12, 0o15), 16, True, device="cpu")
    with pytest.raises(ValueError, match="trellis"):
        tk.trellis_masks(tt.make_rsc(4, 0o16, 0o13))
