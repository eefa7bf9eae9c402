"""Port vs JAX package: ``checkpoint`` and ``debug`` (``srcdsp_tpu_torch/
checkpoint.py``, ``debug.py``, and the leaf order of ``tree.py``).

- The reference tests of ``tests/unit/test_checkpoint.py`` on the port:
  resume bit-exact, block_index atomic with the state, delete, a shape
  mismatch raising.
- The file format is the reference's: the port's ``.npz`` and ``.json``
  keys equal a JAX-written file's; a checkpoint that
  ``srcdsp_tpu.checkpoint.save`` wrote from a JAX `fsk` state is restored by
  the port and streamed on, bits equal to the JAX unbroken run, and the
  other way round: a port-written file resumes on the JAX package (int64
  phase words in [0, 2^32) are stored as uint32).
- For every chain the CLI streams, the port's state flattens to the JAX
  state's leaf paths and shapes, dtypes equal up to the one rule (a u32 /
  int32 leaf into an int64 example), a JAX-written file of it restores, and
  a port-written file of it restores in ``srcdsp_tpu.checkpoint.restore``.
- ``debug``: the reference's three tests, a complex leaf, a nested
  NamedTuple path; `checked` raises `NonFiniteError`, a FloatingPointError.
"""

import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import checkpoint as jck
from srcdsp_tpu_torch import checkpoint, tree
from srcdsp_tpu_torch.chains.fsk import fsk_apply, fsk_init, make_fsk_params
from srcdsp_tpu_torch.debug import NonFiniteError, assert_finite, checked
from srcdsp_tpu_torch.io.capture import CaptureMeta, read_capture_blocks, write_capture
from srcdsp_tpu_torch.testing.signals import fsk_baseband, random_bits, tone
from tests.torch_threads import one_torch_thread  # noqa: F401

DECIM, SPS, DEV, CENTER = 4, 8, 0.05, 0.11
BLOCK = DECIM * SPS * 64


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    rng = np.random.default_rng(0)
    bits = random_bits(rng, (512,))
    x = fsk_baseband(bits, DECIM * SPS, DEV / DECIM) * tone(512 * DECIM * SPS, CENTER)
    cap = str(tmp_path_factory.mktemp("ck") / "cap.cf32")
    write_capture(cap, x, CaptureMeta(fmt="cf32"))
    return cap


def _params():
    return make_fsk_params(CENTER, 64, 0.03, DECIM, SPS, DEV, device="cpu")


def test_resume_bit_exact(capture, tmp_path):
    params = _params()
    ckpt = str(tmp_path / "ckpt")
    st = fsk_init(params)
    outs_a = []
    for i, xb in enumerate(read_capture_blocks(capture, BLOCK)):
        st, (b, _) = fsk_apply(params, st, torch.as_tensor(xb))
        outs_a.append(b.numpy())
        if i == 3:
            checkpoint.save(ckpt, st, block_index=i + 1)
    st_r, start = checkpoint.restore(ckpt, fsk_init(_params()))
    assert start == 4
    outs_b = []
    for xb in read_capture_blocks(capture, BLOCK, start_block=start):
        st_r, (b, _) = fsk_apply(params, st_r, torch.as_tensor(xb))
        outs_b.append(b.numpy())
    np.testing.assert_array_equal(np.concatenate(outs_a[4:]), np.concatenate(outs_b))


def test_block_index_atomic_with_state(tmp_path):
    p = str(tmp_path / "c")
    checkpoint.save(p, fsk_init(_params()), block_index=9)
    with open(p + ".json") as f:
        meta = json.load(f)
    meta["block_index"] = 4                    # a stale sidecar
    with open(p + ".json", "w") as f:
        json.dump(meta, f)
    _, blk = checkpoint.restore(p, fsk_init(_params()))
    assert blk == 9


def test_delete(tmp_path):
    p = str(tmp_path / "c")
    checkpoint.save(p, fsk_init(_params()), 1)
    assert checkpoint.exists(p)
    checkpoint.delete(p)
    assert not checkpoint.exists(p)
    checkpoint.delete(p)                       # idempotent


def test_restore_mismatch_raises(tmp_path):
    ckpt = str(tmp_path / "c")
    checkpoint.save(ckpt, fsk_init(_params()), 0)
    other = fsk_init(make_fsk_params(0.1, 32, 0.05, 2, 4, 0.05, device="cpu"))
    with pytest.raises(ValueError):
        checkpoint.restore(ckpt, other)                     # shape
    with pytest.raises(ValueError):
        checkpoint.restore(ckpt, (fsk_init(_params()), torch.zeros(1)))   # leaf count
    checkpoint.save(ckpt, (torch.zeros(3, dtype=torch.float64),), 0)
    with pytest.raises(ValueError):
        checkpoint.restore(ckpt, (torch.zeros(3),))             # dtype


def test_u32_and_int32_restore_exactly_into_int64(tmp_path):
    ckpt = str(tmp_path / "c")
    words = np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    counts = np.array([-5, 7], np.int32)
    jck.save(ckpt, (jnp.asarray(words), jnp.asarray(counts), jnp.float32(1.5)), 3)
    ex = (torch.zeros(4, dtype=torch.int64), torch.zeros(2, dtype=torch.int64), torch.zeros(()))
    (w, c, f), blk = checkpoint.restore(ckpt, ex)
    assert blk == 3 and w.dtype == c.dtype == torch.int64
    assert w.tolist() == words.tolist() and c.tolist() == counts.tolist() and float(f) == 1.5
    with pytest.raises(ValueError):
        checkpoint.restore(ckpt, (torch.zeros(4, dtype=torch.int32),) + ex[1:])


def test_file_keys_equal_the_reference(tmp_path):
    from srcdsp_tpu.chains import fsk as jfsk

    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    jck.save(jp, jfsk.fsk_init(jfsk.make_fsk_params(CENTER, 64, 0.03, DECIM, SPS, DEV)), 5,
             extra={"a": 1})
    checkpoint.save(tp, fsk_init(_params()), 5, extra={"a": 1})
    assert sorted(np.load(jp + ".npz").files) == sorted(np.load(tp + ".npz").files)
    mj, mt = json.load(open(jp + ".json")), json.load(open(tp + ".json"))
    assert mj.keys() == mt.keys()
    assert {k: mj[k] for k in mj if k != "treedef"} == {k: mt[k] for k in mt if k != "treedef"}


def test_jax_written_checkpoint_resumes_on_the_port(capture, tmp_path):
    """JAX streams 3 blocks and saves; the port restores that file and
    streams the rest: bits equal to JAX's unbroken run."""
    from srcdsp_tpu.chains import fsk as jfsk

    jparams = jfsk.make_fsk_params(CENTER, 64, 0.03, DECIM, SPS, DEV)
    blocks = list(read_capture_blocks(capture, BLOCK))
    st = jfsk.fsk_init(jparams)
    ref = []
    ckpt = str(tmp_path / "jck")
    for i, xb in enumerate(blocks):
        st, (b, _) = jfsk.fsk_apply(jparams, st, jnp.asarray(xb))
        ref.append(np.asarray(b))
        if i == 2:
            jck.save(ckpt, st, block_index=3)
    st_t, start = checkpoint.restore(ckpt, fsk_init(_params()))
    assert start == 3 and st_t.nco.phase.dtype == torch.int64
    got = []
    for xb in blocks[start:]:
        st_t, (b, _) = fsk_apply(_params(), st_t, torch.as_tensor(xb))
        got.append(b.numpy())
    np.testing.assert_array_equal(np.concatenate(ref[start:]), np.concatenate(got))


def _states():
    """(JAX state, port state) of every chain the CLI streams."""
    from srcdsp_tpu.chains import analog as ja, dqpsk as jd, fsk as jf, psk as jp, qam as jq
    from srcdsp_tpu.chains import tracking as jt
    from srcdsp_tpu.ops import fir as jfi, nco as jn, resample as jr
    from srcdsp_tpu_torch.chains import analog as ta, dqpsk as td, fsk as tf, psk as tp
    from srcdsp_tpu_torch.chains import qam as tq, tracking as tt
    from srcdsp_tpu_torch.ops import fir as tfi, nco as tn, resample as tr

    c = "cpu"
    jfp, tfp = jf.make_fsk_params(0.11, 64, 0.1, 4, 8, 0.05), tf.make_fsk_params(
        0.11, 64, 0.1, 4, 8, 0.05, device=c)
    jpp, tpp = jp.make_psk_params(0.1, 4, 8), tp.make_psk_params(0.1, 4, 8, device=c)
    return {
        "fsk": (jf.fsk_init(jfp), tf.fsk_init(tfp)),
        "fsk_tracking": (jt.fsk_track_init(jfp), tt.fsk_track_init(tfp)),
        "psk": (jp.psk_init(jpp), tp.psk_init(tpp)),
        "psk_tracking": (jt.psk_track_init(jpp), tt.psk_track_init(tpp)),
        "dqpsk": (jd.dqpsk_init(jd.make_dqpsk_params(0.1, 4, 8)),
                  td.dqpsk_init(td.make_dqpsk_params(0.1, 4, 8, device=c))),
        "qam": (jq.qam_init(jq.make_qam_params(0.1, 4, 8, order=16)),
                tq.qam_init(tq.make_qam_params(0.1, 4, 8, order=16, device=c))),
        "fm": (ja.fm_init(ja.make_fm_params(0.1, 4, 0.05, num_taps=64, deemph_tau=8.0)),
               ta.fm_init(ta.make_fm_params(0.1, 4, 0.05, num_taps=64, deemph_tau=8.0,
                                            device=c))),
        "fm_stereo": (ja.fm_stereo_rx_init(ja.make_fm_stereo_rx(0.1, 4, 0.05, 19 / 240,
                                                                num_taps=64)),
                      ta.fm_stereo_rx_init(ta.make_fm_stereo_rx(0.1, 4, 0.05, 19 / 240,
                                                                num_taps=64, device=c))),
        "am": (ja.am_init(ja.make_am_params(0.1, 4, num_taps=64)),
               ta.am_init(ta.make_am_params(0.1, 4, num_taps=64, device=c))),
        "resample": (jr.resample_init(96, 3), tr.resample_init(96, 3, device=c)),
        "fir": ((jn.nco_init(), jfi.fir_init(32)), (tn.nco_init(device=c),
                                                     tfi.fir_init(32, device=c))),
    }


STATES = _states()


@pytest.mark.parametrize("name", sorted(STATES))
def test_state_leaves_match_the_reference_and_restore(tmp_path, name):
    js, ts = STATES[name]
    jl = jax.tree_util.tree_flatten_with_path(js)[0]
    tl = tree.flatten_with_path(ts)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        a = np.asarray(a)
        want = torch.empty((), dtype=b.dtype).numpy().dtype
        assert a.shape == tuple(b.shape)
        assert a.dtype == want or (a.dtype == np.uint32 and want == np.int64)
    # a JAX-written file of it (nonzero leaves) restores into the port's state
    rng = np.random.default_rng(1)
    leaves, treedef = jax.tree_util.tree_flatten(js)
    filled = [jnp.asarray((rng.integers(0, 2 ** 32, np.shape(x), dtype=np.uint64)
                           .astype(np.uint32)) if np.asarray(x).dtype == np.uint32
                          else (rng.standard_normal(np.shape(x))
                                + 1j * rng.standard_normal(np.shape(x))).astype(
                                    np.asarray(x).dtype) if np.iscomplexobj(x)
                          else rng.standard_normal(np.shape(x)).astype(np.asarray(x).dtype))
              for x in leaves]
    ckpt = str(tmp_path / "c")
    jck.save(ckpt, jax.tree_util.tree_unflatten(treedef, filled), 7)
    got, blk = checkpoint.restore(ckpt, ts)
    assert blk == 7 and type(got) is type(ts)
    for a, b in zip(filled, tree.flatten(got)[0]):
        assert np.array_equal(np.asarray(a).astype(b.numpy().dtype), b.numpy())


@pytest.mark.parametrize("name", sorted(STATES))
def test_port_written_checkpoint_restores_on_the_reference(tmp_path, name):
    """The port saves its state with nonzero leaves (int64 words up to
    2^32 - 1, floats, complex); ``srcdsp_tpu.checkpoint.restore`` takes the
    file into the JAX example, values equal (u32 words stored as uint32)."""
    js, ts = STATES[name]
    rng = np.random.default_rng(2)
    leaves, treedef = tree.flatten(ts)
    filled = []
    for x in leaves:
        if x.dtype == torch.int64:
            v = rng.integers(0, 2 ** 32, tuple(x.shape), dtype=np.uint64).astype(np.int64)
            v.reshape(-1)[:1] = 2 ** 32 - 1
        elif x.is_complex():
            v = (rng.standard_normal(tuple(x.shape))
                 + 1j * rng.standard_normal(tuple(x.shape))).astype(x.numpy().dtype)
        else:
            v = rng.standard_normal(tuple(x.shape)).astype(x.numpy().dtype)
        filled.append(torch.as_tensor(v))
    ckpt = str(tmp_path / "c")
    checkpoint.save(ckpt, tree.unflatten(treedef, filled), 11)
    got, blk = jck.restore(ckpt, js)
    assert blk == 11
    for a, b in zip(filled, jax.tree_util.tree_leaves(got)):
        b = np.asarray(b)
        assert np.array_equal(a.numpy().astype(b.dtype), b) and np.array_equal(
            a.numpy(), b.astype(a.numpy().dtype))


def test_int64_leaf_outside_u32_stays_int64(tmp_path):
    ckpt = str(tmp_path / "c")
    checkpoint.save(ckpt, (torch.tensor([0, 2 ** 32 - 1]), torch.tensor([-1, 3]),
                           torch.tensor([2 ** 32])), 0)
    data = np.load(ckpt + ".npz")
    assert [data[f"leaf_{i}"].dtype for i in range(3)] == [np.uint32, np.int64, np.int64]
    (a, b, c), _ = checkpoint.restore(ckpt, tuple(torch.zeros(2, dtype=torch.int64)
                                                  for _ in range(2)) + (torch.zeros(1, dtype=torch.int64),))
    assert a.tolist() == [0, 2 ** 32 - 1] and b.tolist() == [-1, 3] and c.tolist() == [2 ** 32]


def test_port_written_checkpoint_resumes_on_the_reference(capture, tmp_path):
    """The port streams 3 blocks and saves; the JAX package restores that
    file and streams the rest: bits equal to JAX's unbroken run."""
    from srcdsp_tpu.chains import fsk as jfsk

    jparams = jfsk.make_fsk_params(CENTER, 64, 0.03, DECIM, SPS, DEV)
    blocks = list(read_capture_blocks(capture, BLOCK))
    st = jfsk.fsk_init(jparams)
    ref = []
    for xb in blocks:
        st, (b, _) = jfsk.fsk_apply(jparams, st, jnp.asarray(xb))
        ref.append(np.asarray(b))
    params, ckpt = _params(), str(tmp_path / "tck")
    st_t = fsk_init(params)
    for xb in blocks[:3]:
        st_t, _ = fsk_apply(params, st_t, torch.as_tensor(xb))
    checkpoint.save(ckpt, st_t, block_index=3)
    st_j, start = jck.restore(ckpt, jfsk.fsk_init(jparams))
    assert start == 3 and np.asarray(st_j.nco.phase).dtype == np.uint32
    got = []
    for xb in blocks[start:]:
        st_j, (b, _) = jfsk.fsk_apply(jparams, st_j, jnp.asarray(xb))
        got.append(np.asarray(b))
    np.testing.assert_array_equal(np.concatenate(ref[start:]), np.concatenate(got))


def test_tree_round_trip_and_order():
    class Inner(NamedTuple):
        b: torch.Tensor
        a: torch.Tensor

    t = {"z": (torch.ones(1), None, [torch.zeros(2)]), "a": Inner(torch.ones(3), torch.ones(4))}
    leaves, td = tree.flatten(t)
    assert [x.numel() for x in leaves] == [3, 4, 1, 2]                # dict keys sorted
    assert [p for p, _ in tree.flatten_with_path(t)[0]] == [
        "['a'].b", "['a'].a", "['z'][0]", "['z'][2][0]"]
    back = tree.unflatten(td, leaves)
    assert isinstance(back["a"], Inner) and back["z"][1] is None and isinstance(back["z"][2], list)
    jt = {"z": (jnp.ones(1), None, [jnp.zeros(2)]), "a": (jnp.ones(3), jnp.ones(4))}
    assert [np.asarray(x).size for x in jax.tree_util.tree_leaves(jt)] == [3, 4, 1, 2]


# --- debug ------------------------------------------------------------------------------

def test_checked_passes_clean():
    f = checked(lambda x: {"y": x * 2.0, "z": (x + 1j * x).to(torch.complex64)})
    out = f(torch.ones(8))
    np.testing.assert_allclose(out["y"].numpy(), 2.0)


def test_checked_catches_nan():
    f = checked(lambda x: torch.log(x))
    with pytest.raises(NonFiniteError):
        f(torch.tensor([-1.0, 2.0]))
    assert issubclass(NonFiniteError, FloatingPointError)


def test_assert_finite():
    assert_finite({"a": torch.ones(4)}, "ok")
    with pytest.raises(FloatingPointError):
        assert_finite({"a": torch.tensor([float("inf")])}, "bad")


def test_checked_names_a_complex_leaf_and_a_nested_namedtuple_path():
    class Timing(NamedTuple):
        acc: torch.Tensor
        last: torch.Tensor

    class State(NamedTuple):
        fir: torch.Tensor
        timing: Timing

    def step(x):
        return State(fir=x + 0j, timing=Timing(acc=x.sum(), last=x)), (x > 0).to(torch.int32)

    f = checked(step)
    f(torch.ones(4))
    bad = torch.ones(4)
    bad[2] = float("nan")
    with pytest.raises(NonFiniteError, match=r"leaf \[0\]\.fir$"):
        f(bad)                                     # the first bad leaf, a complex one
    g = checked(lambda x: {"y": x, "s": State(fir=torch.ones(2, dtype=torch.complex64),
                                              timing=Timing(acc=torch.ones(()), last=1 / x))})
    with pytest.raises(NonFiniteError, match=r"\['s'\]\.timing\.last"):
        g(torch.zeros(3))
    with pytest.raises(FloatingPointError, match=r"bad\[1\]\.timing\.acc"):
        assert_finite((1, State(torch.ones(1), Timing(torch.tensor(float("nan")), torch.ones(1)))),
                      "bad")
    assert checked(step).__name__ == "step"


def test_checked_fsk_on_a_nan_names_the_reference_leaf():
    """A NaN in a block: the reference's `checked` names the first bad leaf
    (its gather does not fault); the port returns NaN symbols, where it
    used to fault, and names the same leaf."""
    from srcdsp_tpu.chains import fsk as jfsk
    from srcdsp_tpu.debug import checked as jchecked

    x = np.ones(BLOCK, np.complex64)
    x[100] = np.nan
    jp = jfsk.make_fsk_params(CENTER, 64, 0.03, DECIM, SPS, DEV)
    with pytest.raises(Exception) as jerr:
        jchecked(lambda s, v: jfsk.fsk_apply(jp, s, v))(jfsk.fsk_init(jp), jnp.asarray(x))
    _, (_, soft) = fsk_apply(_params(), fsk_init(_params()), torch.as_tensor(x))
    assert torch.isnan(soft).all()
    with pytest.raises(NonFiniteError) as err:
        checked(lambda s, v: fsk_apply(_params(), s, v))(fsk_init(_params()), torch.as_tensor(x))
    assert str(err.value).endswith("[0].timing.acc") and "[0].timing.acc" in str(jerr.value)
