"""The port does all that the JAX package does: a static check (AST, no imports).

* Every public name of every ``ofdm_tpu/**.py`` module (each top-level
  function, class and assignment not starting with ``_``) is a public name
  of the port module at the same path under ``ofdm_tpu_torch/`` (defined
  or imported there), or of the module ``MOVED`` names; the TPU kernels'
  module ``ops/pallas_link.py`` maps to the kernel wrapper modules
  (``PALLAS_COUNTERPARTS``); or it stands in ``TPU_ONLY`` with its reason
  (ROADMAP.md, "Deliberately unported").
* Every script of ``examples/``, the root ``plot_constellations.py`` and
  ``notebook/bit_loading.ipynb`` has its counterpart under
  ``ofdm_tpu_torch/examples/``, each module with a ``main``.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(REPO, "ofdm_tpu")
PORT = os.path.join(REPO, "ofdm_tpu_torch")

# A JAX name whose counterpart lives in another port module.
MOVED = {("ops/dft.py", "dft_matrix"): "ops/linops.py"}

# ops/pallas_link.py -> the port's kernel wrappers: (module, name[.method]).
PALLAS_COUNTERPARTS = {
    "boxmuller_sample": ("ops/link_kernel.py", "boxmuller_sample"),
    "selected_passes": ("ops/link_kernel.py", "selected_passes"),
    "lr_factors": ("ops/lr_kernel.py", "lr_factors"),
    "plan_for": ("pipeline.py", "kernel_mode"),
    "supports": ("pipeline.py", "kernel_mode"),
    "make_pallas_chunk": ("ops/link_kernel.py", "diag_chunk"),
    "make_pallas_dump_chunk": ("ops/link_kernel.py", "new_dump"),
    "make_noise_bump_chunk": ("ops/link_kernel.py", "noise_bump_link"),
    "make_carry_probe": ("ops/fold_kernel.py", "fold_probe"),
    "chunk_multiple": ("parallel/sweep.py", "ShardedLinkRunner._chunk_multiple"),
}

_PLANAR = "the TPU's planar-f32 form (it has no complex dtypes); the port's tensors are complex64"
TPU_ONLY = {
    "ops/cplx.py": "the TPU's planar complex helpers (CArray, split_bf16); the port uses torch complex64 and f32 planes",
    ("ops/adaptive.py", "decode_planar"): _PLANAR,
    ("ops/adaptive.py", "encode_planar"): _PLANAR,
    ("ops/adaptive.py", "encode_from_indices_planar"): _PLANAR,
    ("ops/mapping.py", "decode_hard_planar"): _PLANAR,
    ("ops/mapping.py", "encode_indices_planar"): _PLANAR,
    ("ops/mapping.py", "psk_index_planar"): _PLANAR,
    ("ops/mapping.py", "psk_point_planar"): _PLANAR,
    ("ops/mapping.py", "qam_index_planar"): _PLANAR,
    ("ops/mapping.py", "qam_point_planar"): _PLANAR,
    ("ops/allocate.py", "waterfilling_jax"): "the jit-traceable allocation of the TPU's sweeps; the port's is host f64",
    ("parallel/mesh.py", "batch_sharding"): "a jax.sharding placement; each rank of the port holds its own chunk",
    ("parallel/mesh.py", "replicated"): "a jax.sharding placement; each rank of the port holds its own chunk",
    ("parallel/mesh.py", "MC_AXIS"): "the JAX mesh's axis name; a torch.distributed group has ranks, no named axes",
    ("parallel/halo.py", "convolve_stream_sharded"): "the matmul-form stream convolution; the port's eager chain "
                                                     "convolves by taps (parallel/halo.py:15)",
    ("ops/pallas_link.py", "make_pallas_chunk_lifted"): "the jit-shared executable of a Pallas chunk; the port's "
                                                        "chunk wrappers take their constants as arguments",
    ("ops/pallas_link.py", "make_pallas_dump_lifted"): "the jit-shared executable of the dump chunk (as above)",
    ("ops/pallas_link.py", "psk_sector_arith"): "the TPU's atan2-free PSK sector search (Mosaic has no atan2); "
                                                "the CUDA kernels slice PSK in csrc/link_common.cuh",
    ("ops/pallas_link.py", "psk_sector_arith_vec"): "its per-lane-order form (as above)",
}


def _jax_modules():
    for root, _, files in os.walk(JAX):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), JAX)


def _tree(path):
    with open(path) as fh:
        return ast.parse(fh.read())


def _defined(tree):
    """Public top-level names a module defines."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _exported(rel):
    """Every top-level name a port module defines or imports; methods as Class.method."""
    tree = _tree(os.path.join(PORT, rel))
    names = _defined(tree)
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, ast.ClassDef):
            names.update(f"{node.name}.{f.name}" for f in node.body if isinstance(f, ast.FunctionDef))
    return names


def _counterpart(rel, name):
    """(port module, port name) that must hold the JAX module ``rel``'s ``name``."""
    if rel == "ops/pallas_link.py":
        return PALLAS_COUNTERPARTS.get(name)
    return MOVED.get((rel, name), rel), name


@pytest.mark.parametrize("rel", list(_jax_modules()))
def test_every_public_name_has_a_counterpart(rel):
    names = _defined(_tree(os.path.join(JAX, rel)))
    if rel in TPU_ONLY:
        assert not os.path.exists(os.path.join(PORT, rel)), f"{rel} is ported: take it off TPU_ONLY"
        return
    missing = []
    for name in sorted(names):
        where = _counterpart(rel, name)
        if (rel, name) in TPU_ONLY:
            assert where is None or not os.path.exists(os.path.join(PORT, where[0])) or \
                where[1] not in _exported(where[0]), f"{rel}:{name} is ported: take it off TPU_ONLY"
            continue
        if where is None or not os.path.exists(os.path.join(PORT, where[0])) or where[1] not in _exported(where[0]):
            missing.append(name)
    assert not missing, f"ofdm_tpu/{rel}: no counterpart in ofdm_tpu_torch for {missing}"


def test_tpu_only_entries_name_jax_code_and_give_a_reason():
    modules = set(_jax_modules())
    for entry, reason in TPU_ONLY.items():
        rel, name = (entry, None) if isinstance(entry, str) else entry
        assert rel in modules and len(reason) > 20
        if name is not None:
            assert name in _defined(_tree(os.path.join(JAX, rel))), entry
    assert set(PALLAS_COUNTERPARTS) | {n for (r, n) in [e for e in TPU_ONLY if isinstance(e, tuple)]
                                       if r == "ops/pallas_link.py"} == \
        _defined(_tree(os.path.join(JAX, "ops/pallas_link.py")))


def _scripts():
    ex = os.path.join(REPO, "examples")
    return [f[:-3] for f in sorted(os.listdir(ex)) if f.endswith(".py")] + ["plot_constellations"]


@pytest.mark.parametrize("name", _scripts())
def test_every_example_has_a_port_module_with_main(name):
    path = os.path.join(PORT, "examples", f"{name}.py")
    assert os.path.exists(path), f"no ofdm_tpu_torch/examples/{name}.py"
    assert "main" in _defined(_tree(path))


def test_the_notebook_has_a_port_counterpart():
    assert os.path.exists(os.path.join(REPO, "notebook", "bit_loading.ipynb"))
    assert os.path.exists(os.path.join(PORT, "examples", "bit_loading.ipynb"))
