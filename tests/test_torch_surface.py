"""The port's surface against the JAX package's: a static AST guard.

For every module of ``srcdsp_tpu/`` the port's counterpart (same path under
``srcdsp_tpu_torch/``) must exist and offer every public module-level name
of the reference module and every parameter of every public module-level
function. A public name is one not starting with ``_``: a def, a class, an
assigned name, or a name the module imports from its own package (so a
package's re-exports count; names imported from numpy, jax or the standard
library do not). A parameter matches by name.

A difference is allowed only through `ALLOWED`, one entry per (module,
name) or (module, ``function(parameter)``), each with its reason and, for a
rename, the port's name, which must then exist. An entry that no longer
names a real difference fails too, so the table cannot go stale. Nothing of
either package is imported: the files are parsed.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "srcdsp_tpu", ROOT / "srcdsp_tpu_torch"
MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))

# the reasons a reference name or parameter has no counterpart of that name
ALIAS = ("a dtype or constant alias (F32, CF32, I32, U32, TWO_PI, LANE, F32_BIG) that the "
         "reference module imports for its own use; the port's module does not use it, and "
         "the module that defines it exports it in both packages")
IMPORTED = ("a helper the reference module imports for its own use (defined elsewhere in the "
            "package); the port's module does not use it, and its home module exports it")
PALLAS = ("a one-shot `*_pallas` wrapper of a kernel: the port calls the factory's call "
          "function instead (`make_*(...).fn`), named as the replacement")
INTERPRET = ("Pallas interpret mode: a CUDA kernel has none; the port's wrapper runs its plain "
             "PyTorch version for CPU tensors")
PRECISION = ("an XLA / MXU matmul precision: the port computes in float32 with TF32 off "
             "(`ops.fir.pin_f32`)")
TILING = ("a tiling or pipelining choice of the Pallas TPU lowering (block_cols, pipelined, "
          "hist_round, phasor, b_tile): the CUDA kernel takes its geometry from the shapes")
UNROLL = "a lax.scan unroll factor: the port's loop is a Python loop of batched torch ops"
RNG = ("a jax.random key: the port draws from an explicit generator (a numpy `rng`, or a "
       "torch `generator` on the card), named as the replacement")
SHARDS = ("a global time-sharded jax.Array: the port's sharded array is the tuple of this "
          "process's per-shard tensors (`shards`) over a `mesh`")
AXIS = ("a shard_map axis name: the port's time-sharded functions act on the `mesh`'s time "
        "axis (where the function takes no mesh, the axis is its callers')")
USE_KERNEL = "`use_pallas` names the Pallas kernel; the port's switch is `use_kernel`"
TREE = ("renamed `tree_`: the port's module imports the port's `tree` module under that name")
SHADOW = ("a package re-export of a function named as its own submodule: bound in the package, "
          "it would hide the submodule (`from srcdsp_tpu_torch.kernels import fftconv_pallas` "
          "would give the function), which the port's code imports as a module; it is called "
          "from its module")

# (module, name or function(parameter)) -> (reason, the port's replacement or None)
ALLOWED = {
    ("chains/equalizer.py", "F32"): (ALIAS, None),
    ("chains/fhss.py", "F32"): (ALIAS, None),
    ("chains/framesync.py", "CF32"): (ALIAS, None),
    ("chains/fsk_planes.py", "mix_fir_decim_pallas_mc"): (IMPORTED, None),
    ("chains/mlse.py", "I32"): (ALIAS, None),
    ("chains/modem.py", "mix_fir_decim_pallas_mc"): (PALLAS, "make_mix_fir_kernel_mc"),
    ("chains/modem.py", "make_coherent_modem(precision)"): (PRECISION, None),
    ("chains/modem.py", "make_coherent_modem(interpret)"): (INTERPRET, None),
    ("chains/ofdm.py", "I32"): (ALIAS, None),
    ("chains/ofdm.py", "ofdm_tx_frame(preamble_key)"): (RNG, "rng"),
    ("chains/ofdm.py", "schmidl_cox_preamble(key)"): (RNG, "rng"),
    ("chains/ofdm_modem.py", "make_ofdm_coded_modem(precision)"): (PRECISION, None),
    ("chains/ofdm_modem.py", "make_ofdm_coded_modem(interpret)"): (INTERPRET, None),
    ("chains/ofdm_planes.py", "F32"): (ALIAS, None),
    ("chains/ofdm_planes.py", "I32"): (ALIAS, None),
    ("chains/ofdm_planes.py", "make_ofdm_rx_planes(precision)"): (PRECISION, None),
    ("chains/ook.py", "CF32"): (ALIAS, None),
    ("chains/qam.py", "qam_modulate(key)"): (RNG, "rng"),
    ("chains/scfde.py", "F32"): (ALIAS, None),
    ("chains/scfde_planes.py", "F32"): (ALIAS, None),
    ("chains/scfde_planes.py", "I32"): (ALIAS, None),
    ("chains/scfde_planes.py", "make_scfde_rx_planes(precision)"): (PRECISION, None),
    ("chains/tracking_planes.py", "U32"): (ALIAS, None),
    ("chains/tracking_planes.py", "gardner_free_cap"): (IMPORTED, None),
    ("chains/tracking_planes.py", "phase_coef_matrix"): (IMPORTED, None),
    ("configs.py", "build_config1(use_pallas)"): (USE_KERNEL, "use_kernel"),
    ("configs.py", "build_config1(interpret)"): (INTERPRET, None),
    ("debug.py", "assert_finite(tree)"): (TREE, "tree_"),
    ("demap.py", "F32_BIG"): (ALIAS, None),
    ("dist/channelize.py", "shift_from_left"): (IMPORTED, None),
    ("dist/channelize.py", "channelize_os2_time_sharded(x)"): (SHARDS, "shards"),
    ("dist/channelize.py", "channelize_time_sharded(x)"): (SHARDS, "shards"),
    ("dist/channelize.py", "channelize_time_sharded_stream(x)"): (SHARDS, "shards"),
    ("dist/fused.py", "MixFirKernel"): (IMPORTED, None),
    ("dist/fused.py", "fftconv_time_sharded(x_planes)"): (SHARDS, "shards"),
    ("dist/fused.py", "mix_fir_time_sharded(x_planes)"): (SHARDS, "shards"),
    ("dist/halo.py", "fir_time_sharded(x)"): (SHARDS, "shards"),
    ("dist/halo.py", "fir_time_sharded_stream(x)"): (SHARDS, "shards"),
    ("dist/halo.py", "halo_from_left(x)"): (SHARDS, "shards"),
    ("dist/halo.py", "halo_from_left(axis_name)"): (AXIS, "mesh"),
    ("dist/halo.py", "shift_from_left(x)"): (SHARDS, "shards"),
    ("dist/halo.py", "shift_from_left(axis_name)"): (AXIS, "mesh"),
    ("fec.py", "bpsk_soft(key)"): (RNG, "generator"),
    ("kernels/__init__.py", "fftconv_pallas"): (SHADOW, None),
    ("kernels/__init__.py", "mix_fir_ctaps_pallas"): (PALLAS, "make_mix_fir_ctaps_kernel"),
    ("kernels/__init__.py", "mix_fir_decim_pallas"): (PALLAS, "make_mix_fir_kernel"),
    ("kernels/__init__.py", "mix_fir_decim_pallas_mc"): (PALLAS, "make_mix_fir_kernel_mc"),
    ("kernels/__init__.py", "mix_resample_pallas"): (PALLAS, "make_mix_resample_kernel"),
    ("kernels/__init__.py", "mix_resample_pallas_mc"): (PALLAS, "make_mix_resample_kernel_mc"),
    ("kernels/bank_pallas.py", "F32"): (ALIAS, None),
    ("kernels/bank_pallas.py", "make_bank_kernel(interpret)"): (INTERPRET, None),
    ("kernels/bank_pallas.py", "make_bank_psk_kernel(interpret)"): (INTERPRET, None),
    ("kernels/bcjr_pallas.py", "make_bcjr_kernel(interpret)"): (INTERPRET, None),
    ("kernels/bcjr_pallas.py", "turbo_decode_pallas(interpret)"): (INTERPRET, None),
    ("kernels/ctaps_aligned.py", "F32"): (ALIAS, None),
    ("kernels/ctaps_aligned.py", "TWO_PI"): (ALIAS, None),
    ("kernels/ctaps_aligned.py", "ctaps_aligned_pallas"): (PALLAS, "make_ctaps_aligned_kernel"),
    ("kernels/ctaps_aligned.py", "make_ctaps_aligned_kernel(precision)"): (PRECISION, None),
    ("kernels/ctaps_aligned.py", "make_ctaps_aligned_kernel(interpret)"): (INTERPRET, None),
    ("kernels/fft_pallas.py", "F32"): (ALIAS, None),
    ("kernels/fftconv_pallas.py", "F32"): (ALIAS, None),
    ("kernels/fsk_ctaps.py", "make_fsk_ctaps_kernel(block_cols)"): (TILING, None),
    ("kernels/fsk_ctaps.py", "make_fsk_ctaps_kernel(precision)"): (PRECISION, None),
    ("kernels/fsk_ctaps.py", "make_fsk_ctaps_kernel(pipelined)"): (TILING, None),
    ("kernels/fsk_ctaps.py", "make_fsk_ctaps_kernel(interpret)"): (INTERPRET, None),
    ("kernels/fsk_fused.py", "banded_taps"): (IMPORTED, None),
    ("kernels/fsk_fused.py", "make_fsk_mc_kernel(block_cols)"): (TILING, None),
    ("kernels/fsk_fused.py", "make_fsk_mc_kernel(precision)"): (PRECISION, None),
    ("kernels/fsk_fused.py", "make_fsk_mc_kernel(pipelined)"): (TILING, None),
    ("kernels/fsk_fused.py", "make_fsk_mc_kernel(interpret)"): (INTERPRET, None),
    ("kernels/fsk_preframed.py", "TWO_PI"): (ALIAS, None),
    ("kernels/fsk_preframed.py", "make_fsk_preframed_kernel(block_cols)"): (TILING, None),
    ("kernels/fsk_preframed.py", "make_fsk_preframed_kernel(precision)"): (PRECISION, None),
    ("kernels/fsk_preframed.py", "make_fsk_preframed_kernel(interpret)"): (INTERPRET, None),
    ("kernels/halo_dma.py", "halo_from_left_pallas(x)"): (SHARDS, "shards"),
    ("kernels/halo_dma.py", "halo_from_left_pallas(axis_name)"): (AXIS, "mesh"),
    ("kernels/halo_dma.py", "halo_from_left_pallas(interpret)"): (INTERPRET, None),
    ("kernels/halo_fused.py", "F32"): (ALIAS, None),
    ("kernels/halo_fused.py", "TWO_PI"): (ALIAS, None),
    ("kernels/halo_fused.py", "banded_taps"): (IMPORTED, None),
    ("kernels/halo_fused.py", "make_halo_fused_kernel(precision)"): (PRECISION, None),
    ("kernels/halo_fused.py", "make_halo_fused_kernel(axis_name)"): (AXIS, None),
    ("kernels/halo_fused.py", "make_halo_fused_kernel(interpret)"): (INTERPRET, None),
    ("kernels/halo_fused.py", "mix_fir_halo_sharded(x_planes)"): (SHARDS, "shards"),
    ("kernels/ldpc_pallas.py", "ldpc_decode_pallas(b_tile)"): (TILING, None),
    ("kernels/ldpc_pallas.py", "ldpc_decode_pallas(interpret)"): (INTERPRET, None),
    ("kernels/ldpc_pallas.py", "make_ldpc_decoder(b_tile)"): (TILING, None),
    ("kernels/ldpc_pallas.py", "make_ldpc_decoder(interpret)"): (INTERPRET, None),
    ("kernels/ldpc_pallas.py", "make_ldpc_kernel(interpret)"): (INTERPRET, None),
    ("kernels/ldpc_pallas.py", "make_qc_decoder(b_tile)"): (TILING, None),
    ("kernels/ldpc_pallas.py", "make_qc_decoder(interpret)"): (INTERPRET, None),
    ("kernels/ldpc_pallas.py", "make_qc_decoder_t(interpret)"): (INTERPRET, None),
    ("kernels/ldpc_pallas.py", "make_qc_kernel(interpret)"): (INTERPRET, None),
    ("kernels/ldpc_pallas.py", "qc_decode_layered_pallas(b_tile)"): (TILING, None),
    ("kernels/ldpc_pallas.py", "qc_decode_layered_pallas(interpret)"): (INTERPRET, None),
    ("kernels/mixfir.py", "F32"): (ALIAS, None),
    ("kernels/mixfir.py", "U32"): (ALIAS, None),
    ("kernels/mixfir.py", "mix_fir_decim_pallas"): (PALLAS, "make_mix_fir_kernel"),
    ("kernels/mixfir.py", "mix_fir_decim_pallas_mc"): (PALLAS, "make_mix_fir_kernel_mc"),
    ("kernels/mixfir.py", "make_mix_fir_kernel(block_cols)"): (TILING, None),
    ("kernels/mixfir.py", "make_mix_fir_kernel(precision)"): (PRECISION, None),
    ("kernels/mixfir.py", "make_mix_fir_kernel(phasor)"): (TILING, None),
    ("kernels/mixfir.py", "make_mix_fir_kernel(pipelined)"): (TILING, None),
    ("kernels/mixfir.py", "make_mix_fir_kernel(interpret)"): (INTERPRET, None),
    ("kernels/mixfir.py", "make_mix_fir_kernel_mc(block_cols)"): (TILING, None),
    ("kernels/mixfir.py", "make_mix_fir_kernel_mc(precision)"): (PRECISION, None),
    ("kernels/mixfir.py", "make_mix_fir_kernel_mc(pipelined)"): (TILING, None),
    ("kernels/mixfir.py", "make_mix_fir_kernel_mc(interpret)"): (INTERPRET, None),
    ("kernels/mixfir_ctaps.py", "F32"): (ALIAS, None),
    ("kernels/mixfir_ctaps.py", "TWO_PI"): (ALIAS, None),
    ("kernels/mixfir_ctaps.py", "mix_fir_ctaps_pallas"): (PALLAS, "make_mix_fir_ctaps_kernel"),
    ("kernels/mixfir_ctaps.py", "toeplitz_taps"): (IMPORTED, None),
    ("kernels/mixfir_ctaps.py", "make_mix_fir_ctaps_kernel(block_cols)"): (TILING, None),
    ("kernels/mixfir_ctaps.py", "make_mix_fir_ctaps_kernel(precision)"): (PRECISION, None),
    ("kernels/mixfir_ctaps.py", "make_mix_fir_ctaps_kernel(pipelined)"): (TILING, None),
    ("kernels/mixfir_ctaps.py", "make_mix_fir_ctaps_kernel(interpret)"): (INTERPRET, None),
    ("kernels/mixfir_preframed.py", "F32"): (ALIAS, None),
    ("kernels/mixfir_preframed.py", "TWO_PI"): (ALIAS, None),
    ("kernels/mixfir_preframed.py", "make_ctaps_preframed_kernel(block_cols)"): (TILING, None),
    ("kernels/mixfir_preframed.py", "make_ctaps_preframed_kernel(precision)"): (PRECISION, None),
    ("kernels/mixfir_preframed.py", "make_ctaps_preframed_kernel(interpret)"): (INTERPRET, None),
    ("kernels/mixfir_preframed.py", "make_frame_kernel(interpret)"): (INTERPRET, None),
    ("kernels/mixfir_rows.py", "F32"): (ALIAS, None),
    ("kernels/mixfir_rows.py", "TWO_PI"): (ALIAS, None),
    ("kernels/mixfir_rows.py", "mix_fir_rows_pallas"): (PALLAS, "make_mix_fir_rows_kernel"),
    ("kernels/mixfir_rows.py", "toeplitz_taps"): (IMPORTED, None),
    ("kernels/mixfir_rows.py", "make_mix_fir_rows_kernel(precision)"): (PRECISION, None),
    ("kernels/mixfir_rows.py", "make_mix_fir_rows_kernel(interpret)"): (INTERPRET, None),
    ("kernels/resample_pallas.py", "MixFirKernel"): (IMPORTED, None),
    ("kernels/resample_pallas.py", "mix_resample_pallas"): (PALLAS, "make_mix_resample_kernel"),
    ("kernels/resample_pallas.py", "mix_resample_pallas_mc"): (PALLAS, "make_mix_resample_kernel_mc"),
    ("kernels/resample_pallas.py", "make_mix_resample_kernel(block_cols)"): (TILING, None),
    ("kernels/resample_pallas.py", "make_mix_resample_kernel(precision)"): (PRECISION, None),
    ("kernels/resample_pallas.py", "make_mix_resample_kernel(hist_round)"): (TILING, None),
    ("kernels/resample_pallas.py", "make_mix_resample_kernel(pipelined)"): (TILING, None),
    ("kernels/resample_pallas.py", "make_mix_resample_kernel(interpret)"): (INTERPRET, None),
    ("kernels/resample_pallas.py", "make_mix_resample_kernel_mc(block_cols)"): (TILING, None),
    ("kernels/resample_pallas.py", "make_mix_resample_kernel_mc(precision)"): (PRECISION, None),
    ("kernels/resample_pallas.py", "make_mix_resample_kernel_mc(hist_round)"): (TILING, None),
    ("kernels/resample_pallas.py", "make_mix_resample_kernel_mc(pipelined)"): (TILING, None),
    ("kernels/resample_pallas.py", "make_mix_resample_kernel_mc(interpret)"): (INTERPRET, None),
    ("kernels/resample_preframed.py", "F32"): (ALIAS, None),
    ("kernels/resample_preframed.py", "LANE"): (ALIAS, None),
    ("kernels/resample_preframed.py", "make_resample_preframed_kernel(block_cols)"): (TILING, None),
    ("kernels/resample_preframed.py", "make_resample_preframed_kernel(precision)"): (PRECISION, None),
    ("kernels/resample_preframed.py", "make_resample_preframed_kernel(interpret)"): (INTERPRET, None),
    ("ldpc.py", "F32_BIG"): (ALIAS, None),
    ("ldpc.py", "ldpc_decode(unroll)"): (UNROLL, None),
    ("mimo.py", "F32"): (ALIAS, None),
    ("ops/channelize_planes.py", "F32"): (ALIAS, None),
    ("ops/channelize_planes.py", "make_channelize_os2_planes(precision)"): (PRECISION, None),
    ("ops/channelize_planes.py", "make_channelize_planes(precision)"): (PRECISION, None),
    ("ops/channelize_planes.py", "make_synthesize_planes(precision)"): (PRECISION, None),
    ("ops/cic.py", "F32"): (ALIAS, None),
    ("ops/decimplan.py", "HalfbandState"): (IMPORTED, None),
    ("ops/farrow.py", "I32"): (ALIAS, None),
    ("ops/fft_planes.py", "F32"): (ALIAS, None),
    ("ops/fftconv_planes.py", "F32"): (ALIAS, None),
    ("ops/fir.py", "complex_conv(precision)"): (PRECISION, None),
    ("ops/fir.py", "fir_apply(precision)"): (PRECISION, None),
    ("ops/fir.py", "fir_full(precision)"): (PRECISION, None),
    ("ops/fresh.py", "F32"): (ALIAS, None),
    ("ops/fresh_planes.py", "U32"): (ALIAS, None),
    ("ops/halfband.py", "F32"): (ALIAS, None),
    ("ops/iir.py", "iir_apply(precision)"): (PRECISION, None),
    ("ops/iir.py", "iir_full(precision)"): (PRECISION, None),
    ("ops/iir.py", "sos_apply(precision)"): (PRECISION, None),
    ("ops/nco.py", "CF32"): (ALIAS, None),
    ("ops/nco.py", "F32"): (ALIAS, None),
    ("ops/nco.py", "U32"): (ALIAS, None),
    ("ops/planes.py", "U32"): (ALIAS, None),
    ("ops/resample.py", "complex_conv"): (IMPORTED, None),
    ("ops/resample.py", "resample_apply(precision)"): (PRECISION, None),
    ("ops/resample.py", "resample_full(precision)"): (PRECISION, None),
    ("testing/channel.py", "F32"): (ALIAS, None),
    ("testing/channel.py", "add_noise_snr(key)"): (RNG, "rng"),
    ("testing/channel.py", "jakes_fading(key)"): (RNG, "rng"),
    ("testing/channel.py", "phase_noise(key)"): (RNG, "rng"),
    ("testing/channel.py", "rayleigh_taps(key)"): (RNG, "rng"),
    ("testing/signals.py", "CF32"): (ALIAS, None),
    ("testing/signals.py", "F32"): (ALIAS, None),
    ("testing/signals.py", "TWO_PI"): (ALIAS, None),
    ("testing/signals.py", "complex_awgn(key)"): (RNG, "rng"),
    ("testing/signals.py", "psk_symbols(key)"): (RNG, "rng"),
    ("testing/signals.py", "random_bits(key)"): (RNG, "rng"),
    ("turbo.py", "I32"): (ALIAS, None),
}


def surface(path: Path, package: str) -> tuple[set[str], dict[str, list[str]]]:
    """(public module-level names, {public function: parameter names}) of a
    module, parsed."""
    names, funcs = set(), {}
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
            a = node.args
            funcs[node.name] = ([x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
                                + [x.arg for x in (a.vararg, a.kwarg) if x is not None])
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                names.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
        elif isinstance(node, ast.ImportFrom):
            if node.level > 0 or (node.module or "").split(".")[0] == package:
                names.update(al.asname or al.name for al in node.names)
        elif isinstance(node, ast.Import):
            names.update(al.asname or al.name.split(".")[0] for al in node.names
                         if al.name.split(".")[0] == package)
    return ({n for n in names if not n.startswith("_")},
            {k: v for k, v in funcs.items() if not k.startswith("_")})


def differences(module: str) -> tuple[list[str], set[str], dict[str, list[str]]]:
    """The reference names and function(parameter)s of `module` that the
    port's counterpart lacks, and the port's surface."""
    ref_names, ref_funcs = surface(REF / module, "srcdsp_tpu")
    names, funcs = surface(PORT / module, "srcdsp_tpu_torch")
    gaps = sorted(ref_names - names)
    for f, params in sorted(ref_funcs.items()):
        if f in funcs:
            gaps += [f"{f}({p})" for p in params if p not in funcs[f]]
    return gaps, names, funcs


@pytest.mark.parametrize("module", MODULES)
def test_port_module_offers_the_reference_surface(module):
    assert (PORT / module).is_file(), f"srcdsp_tpu_torch/{module} is missing"
    gaps, names, funcs = differences(module)
    undocumented = [g for g in gaps if (module, g) not in ALLOWED]
    assert not undocumented, f"srcdsp_tpu_torch/{module} lacks {undocumented}"
    stale = [k for m, k in ALLOWED if m == module and k not in gaps]
    assert not stale, f"ALLOWED entries for {module} name no difference: {stale}"
    for g in gaps:
        reason, new = ALLOWED[(module, g)]
        if new is None:
            continue
        if "(" in g:
            f = g[:g.index("(")]
            assert new in funcs[f], f"{module}: {f} has no {new!r} for {g} ({reason})"
        else:
            assert new in names, f"{module}: no {new!r} for {g} ({reason})"


def test_allowed_entries_name_reference_modules_with_a_reason():
    assert {m for m, _ in ALLOWED} <= set(MODULES)
    for (module, key), (reason, new) in ALLOWED.items():
        assert isinstance(reason, str) and len(reason) > 40, (module, key)
        assert new is None or isinstance(new, str), (module, key)


def test_no_package_reexport_hides_a_submodule():
    """A name a port package's __init__ imports from elsewhere is never the
    name of one of its own submodules (the function would replace the module
    as the package's attribute)."""
    for init in sorted(PORT.rglob("__init__.py")):
        pkg = init.parent
        subs = {p.stem for p in pkg.glob("*.py")} | {p.name for p in pkg.iterdir() if p.is_dir()}
        dotted = ".".join(pkg.relative_to(ROOT).parts)
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom) and node.module != dotted:
                hidden = [a.asname or a.name for a in node.names if (a.asname or a.name) in subs]
                assert not hidden, f"{init.relative_to(ROOT)} binds {hidden} over submodules"
