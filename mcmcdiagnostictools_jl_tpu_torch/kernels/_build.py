"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` for ``sm_90a``, all
started together, and the objects link into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds, not minutes). The library lands in ``_build/<hash>/`` inside the
package, keyed by a hash of the sources, the headers they share
(``csrc/*.cuh``), the flags and the macros defined (``defines``: a timing
study's variant of a kernel; the package itself defines none), so an
unchanged tree does not rebuild. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB_NAME = "libmdt_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of csrc/*.cu's extern "C" entry points (all return
# cudaGetLastError() as int)
_SIGNATURES = {
    "mdt_moments_autocov": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    "mdt_column_minmax": (_P, _L, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    "mdt_hist_tables": (_P, _L, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                        _P, _P, _P, _P),
    "mdt_rank_lookup_wide": (_P, _L, _I, _P, _P, _P, _P, _P, _P, _I, _F, _I, _I,
                             _P, _P),
    "mdt_rank_lookup_gather": (_P, _L, _I, _P, _P, _P, _P, _P, _P, _I, _F, _P,
                               _P),
    "mdt_slab_copy": (_P, _P, _L, _I, _I, _I, _I, _I, _P, _P),
    "mdt_direct_autocov": (_P, _I, _I, _I, _P, _P),
    "mdt_lagloop_a": (_P, _I, _I, _I, _P, _P),
    "mdt_lagloop_b": (_P, _I, _I, _I, _P, _P),
    "mdt_sort_pass": (_P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _P),
    "mdt_sort_pass_occupancy": (_I, _I, _P),
    "mdt_sort_chunk": (_P, _P, _L, _I, _I, _I, _P, _P),
    "mdt_sort_wide": (_P, _P, _L, _I, _L, _I, _I, _P),
    "mdt_valley_merge": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P),
    "mdt_segment_moments": (_P, _P, _I, _I, _I, _I, _L, _L, _P, _P, _P, _P, _P,
                            _P, _I, _P),
    "mdt_blom_table": (_I, _F, _P, _P),
    "mdt_tied_ranks": (_P, _P, _P, _I, _I, _I, _P, _F, _P, _P, _P, _P),
    "mdt_tied_ranks_place": (_P, _P, _P, _I, _I, _P, _P),
    "mdt_blom_counts": (_P, _L, _I, _F, _P),
    "mdt_radix_sort": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "mdt_merge_count": (_P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash(defines: tuple[str, ...] = ()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(defines: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Compile the kernels, with the macros ``defines`` defined, unless a
    library for these sources and macros exists.

    Returns ``(library path, compiler output)``; the output is empty when
    the library was already built. Raises ``RuntimeError`` with nvcc's
    output when the build fails.
    """
    out_dir = BUILD_DIR / source_hash(defines)
    lib = out_dir / _LIB_NAME
    if lib.is_file():
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        srcs = _sources()
        objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines),
                              "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for src, obj in zip(srcs, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        # link under a temporary name and rename, so a concurrent loader
        # never sees a half-written library
        so = Path(tmp) / _LIB_NAME
        proc = subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{proc.stdout}{proc.stderr}")
        os.replace(so, lib)
    return lib, log


@functools.cache
def library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with every entry
    point's ``argtypes``/``restype`` declared."""
    path, _ = build(defines)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
