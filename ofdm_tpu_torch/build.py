"""Build the port's CUDA kernels and load them through ctypes.

Each library compiles one ``csrc/<source>.cu`` with nvcc into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), named by a digest of its sources and flags under
``ofdm_tpu_torch/_build/``.  Each chunk source builds twice: plainly, and
with ``-DOFDM_STAGED=1`` into its ``*_staged`` library, which holds the
_Spec stages (link_common.cuh), so that the plain build's kernels compile
from the code they had; the fold, lr, mm, diag_wide, fold_wide and
mm_wide sources a third time with ``-DOFDM_BUMP=1`` as well, into
``*_bump``, whose mains hold the noise-bump stages (the staged build's keep the code they had, and the
builds run side by side).  A library is built at its first use in a
process; :func:`build` compiles several at once, one nvcc process each.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
# library -> (source in csrc/, extra nvcc flags)
LIBRARIES = {
    "link_kernel": ("link_kernel", ()),
    "diag_wide": ("diag_wide_kernel", ()),
    "fold_kernel": ("fold_kernel", ()),
    "lr_kernel": ("lr_kernel", ()),
    "mm_kernel": ("mm_kernel", ()),
    "fold_wide": ("fold_wide_kernel", ()),
    "mm_wide": ("mm_wide_kernel", ()),
    "boxmuller": ("boxmuller", ()),
    "link_staged": ("link_kernel", ("-DOFDM_STAGED=1",)),
    "diag_wide_staged": ("diag_wide_kernel", ("-DOFDM_STAGED=1",)),
    "fold_staged": ("fold_kernel", ("-DOFDM_STAGED=1",)),
    "lr_staged": ("lr_kernel", ("-DOFDM_STAGED=1",)),
    "mm_staged": ("mm_kernel", ("-DOFDM_STAGED=1",)),
    "fold_wide_staged": ("fold_wide_kernel", ("-DOFDM_STAGED=1",)),
    "mm_wide_staged": ("mm_wide_kernel", ("-DOFDM_STAGED=1",)),
    "diag_wide_bump": ("diag_wide_kernel", ("-DOFDM_STAGED=1", "-DOFDM_BUMP=1")),
    "fold_bump": ("fold_kernel", ("-DOFDM_STAGED=1", "-DOFDM_BUMP=1")),
    "lr_bump": ("lr_kernel", ("-DOFDM_STAGED=1", "-DOFDM_BUMP=1")),
    "mm_bump": ("mm_kernel", ("-DOFDM_STAGED=1", "-DOFDM_BUMP=1")),
    "fold_wide_bump": ("fold_wide_kernel", ("-DOFDM_STAGED=1", "-DOFDM_BUMP=1")),
    "mm_wide_bump": ("mm_wide_kernel", ("-DOFDM_STAGED=1", "-DOFDM_BUMP=1")),
}
SOURCES = tuple(LIBRARIES)
# -fmad=false: every multiply rounds before its add, as in the plain
# PyTorch versions, so kernel and plain agree operation for operation.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
# The stage arguments of every chunk entry point: rows, stage bits, the
# normalization partials and factors, the dump planes and their rows.
_STAGES = [_P, _I, _P, _P, _P, _P, _I]
# The carry-in of the fold, lr and mm chunks: the tail pair, or null.
_PREV = [_P, _P]
# K3's entry points (ofdm_{fold,lr,mm}_probe) after their matrix arguments:
# n, T, E, the codec, the symbol, the key, rows and stage bits, the carry
# row pair, the tail pair.  fold's and mm's take the listed TX terms (p,
# idx, chunks) first and the stream last; lr's its tail factor pair first
# and its row table and tail rows before the stream.
_PROBE_ARGS = [_I] * 9 + [_F] + [_P] * 2 + [ctypes.c_ulonglong] + [_U] * 2 + [_P, _I] + [_P] * 4
_PROBE = ([_P, _P, _I] + _PROBE_ARGS + [_P], _I)
# The C entry points of each source's libraries with their (argtypes,
# restype), set once when a library loads.
# The wide fold and mm chunks (ofdm_{fold,mm}_wide_chunk): taps, twiddles and
# equalizer rows, n, T, E, the DFT split and scale, the codec, the equalizer
# scalars and switches, sym0, the chunk geometry, the key, the outputs, the
# stages, the carry-in, the stream; and their probes.
_WIDE = ([_P] * 9 + [_I] * 6 + [_F] + [_I] * 6 + [_F] + [_P] * 2 + [_F] * 3 + [_I] * 3 + [ctypes.c_ulonglong]
         + [_I] * 5 + [_U] * 2 + [_P] * 5 + _STAGES + _PREV + [_P], _I)
_WIDE_PROBE = ([_P] * 2 + [_I] * 6 + [_F] + [_I] * 7 + [_F] + [_P] * 2 + [ctypes.c_ulonglong] + [_U] * 2
               + [_P, _I] + [_P] * 4 + [_P], _I)
_WIDE_GEOMETRY = ([_I] * 4 + [ctypes.POINTER(ctypes.c_int)], _I)
_DIAG = [_P] * 9 + [_I] * 8 + [_F] + [_P] * 2 + [_F] * 3 + [_I] * 2 + [ctypes.c_ulonglong] + [_I] * 7 + [_U] * 2 \
    + [_P] * 5 + _STAGES
# The diag chunks (ofdm_diag_chunk, ofdm_diag_wide_chunk): _DIAG, then the
# one-pass scratch (the e planes, the TX index plane, the slab), the in-run
# IDFT's plan (the twiddle pair, n1, n2, log2 n, the scale), txext, the stream.
_DIAG_CHUNK = (_DIAG + [_P] * 3 + [_I] + [_P] * 2 + [_I] * 3 + [_F, _I, _P], _I)
SIGNATURES = {
    # ofdm_diag{,_wide}_geometry write the diag kernels' layout into sixteen ints
    "link_kernel": {
        "ofdm_diag_chunk": _DIAG_CHUNK,
        "ofdm_diag_geometry": ([_I, ctypes.POINTER(ctypes.c_int)], _I),
    },
    "diag_wide_kernel": {
        "ofdm_diag_wide_chunk": _DIAG_CHUNK,
        "ofdm_diag_wide_geometry": ([_I, _I, ctypes.POINTER(ctypes.c_int)], _I),
    },
    # the fold and mm chunks take each matrix as its listed terms (p, idx,
    # chunks: ops/terms.py); ofdm_{fold,mm}_geometry write the kernels'
    # layout into thirteen ints
    "fold_kernel": {
        "ofdm_fold_chunk": (
            [_P, _P, _I] * 3 + [_P] * 5 + [_I] * 9 + [_F] + [_P] * 2 + [_F] * 3 + [_I] * 3 + [ctypes.c_ulonglong]
            + [_I] * 5 + [_U] * 2 + [_P] * 5 + _STAGES + _PREV + [_P],
            _I,
        ),
        "ofdm_fold_probe": _PROBE,
        "ofdm_fold_geometry": ([_I] * 3 + [ctypes.POINTER(ctypes.c_int)], _I),
    },
    # lr's chunk takes its row table (lr_kernel.row_table) and its three row
    # counts after the carry-in, its probe the table and the tail rows after
    # the outputs; ofdm_lr_geometry writes lr_main's layout into eight ints
    "lr_kernel": {
        "ofdm_lr_chunk": (
            [_P] * 15 + [_I] * 10 + [_F] + [_P] * 2 + [_F] * 4 + [_I] * 4 + [ctypes.c_ulonglong]
            + [_I] * 5 + [_U] * 2 + [_P] * 5 + _STAGES + _PREV + [_P] + [_I] * 3 + [_P],
            _I,
        ),
        "ofdm_lr_probe": ([_P] * 2 + _PROBE_ARGS + [_P, _I, _P], _I),
        "ofdm_lr_geometry": ([_I] * 4 + [ctypes.POINTER(ctypes.c_int)], _I),
    },
    "mm_kernel": {
        "ofdm_mm_chunk": (
            [_P, _P, _I] * 4 + [_P] * 5 + [_I] * 9 + [_F] + [_P] * 2 + [_F] * 3 + [_I] * 3 + [ctypes.c_ulonglong]
            + [_I] * 4 + [_U] * 2 + [_P] * 7 + _STAGES + _PREV + [_P],
            _I,
        ),
        "ofdm_mm_probe": _PROBE,
        "ofdm_mm_geometry": ([_I] * 3 + [ctypes.POINTER(ctypes.c_int)], _I),
    },
    # ofdm_{fold,mm}_wide_geometry write the wide kernels' layout into thirteen ints
    "fold_wide_kernel": {"ofdm_fold_wide_chunk": _WIDE, "ofdm_fold_wide_probe": _WIDE_PROBE,
                         "ofdm_fold_wide_geometry": _WIDE_GEOMETRY},
    "mm_wide_kernel": {"ofdm_mm_wide_chunk": _WIDE, "ofdm_mm_wide_probe": _WIDE_PROBE,
                       "ofdm_mm_wide_geometry": _WIDE_GEOMETRY},
    "boxmuller": {
        "ofdm_boxmuller": ([_P, _P, ctypes.c_longlong, _U, _U, _P], _I),
        # ofdm_boxmuller's grid, block, step, registers, local bytes and blocks an SM
        "ofdm_boxmuller_geometry": ([ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)], _I),
        "ofdm_philox": ([_P, ctypes.c_longlong] + [_U] * 4 + [_P], _I),
        "ofdm_philox_plane": ([_P, ctypes.c_longlong, _I, ctypes.c_ulonglong] + [_U] * 3 + [_P], _I),
        "ofdm_normal_pair": ([_P, _P, ctypes.c_longlong, _I, ctypes.c_ulonglong] + [_U] * 3 + [_P], _I),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _headers():
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))


def library_path(name: str) -> str:
    source, extra = LIBRARIES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS + extra).encode())
    for f in [f"{source}.cu", *_headers()]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that are not built yet, all at once.

    Returns {name: seconds} for what was compiled; raises RuntimeError with
    nvcc's output if any compile fails.  ptxas's register/spill report goes
    to ``_build/<name>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        source, extra = LIBRARIES[name]
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", tmp, os.path.join(CSRC, f"{source}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out)
    seconds = {}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "wb") as fh:
            fh.write(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of ``LIBRARIES``), built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            lib.ofdm_error_string.argtypes = [ctypes.c_int]
            lib.ofdm_error_string.restype = ctypes.c_char_p
            for fname, (argtypes, restype) in SIGNATURES[LIBRARIES[name][0]].items():
                fn = getattr(lib, fname)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.ofdm_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
