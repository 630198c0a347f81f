"""Build and load the package's CUDA kernels.

At first use the sources `ops/csrc/*.cu` are compiled with nvcc for sm_90a
into one shared library with a plain C interface, which is loaded with
ctypes. The library goes to `sealdnerf_tpu_torch/_build/<hash>/`, keyed by a
hash of the sources and flags, so an unchanged tree builds once.

nvcc is looked up on PATH, then under $CUDA_HOME (default /usr/local/cuda).
A missing compiler or a failed build raises: there is no fallback.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libsdn_kernels.so"


def find_nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of sealdnerf_tpu_torch are compiled at first use and need "
        "the CUDA toolkit. CPU tensors use the plain PyTorch versions.")


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the build directory (once per source hash)
    and return the library's path. nvcc's output, with the per-kernel
    register and shared-memory report, is kept beside it in nvcc.log."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                          *map(str, _sources())],
                         capture_output=True, text=True)
    (out_dir / "nvcc.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {res.returncode}:\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C functions' signatures."""
    lib = ctypes.CDLL(str(build()))
    vp, i64, f32, i32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                         ctypes.c_int)
    lib.sdn_field_fwd.argtypes = [vp, vp, i64, vp, vp,
                                  ctypes.POINTER(ctypes.c_longlong), f32,
                                  i32, i32, vp, vp]
    lib.sdn_field_fwd.restype = ctypes.c_int
    return lib
