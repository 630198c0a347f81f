"""Build and load the package's CUDA kernels.

At first use each source `ops/csrc/*.cu` is compiled with its own nvcc
for sm_90a, all of them at once, and the objects are linked into one shared
library with a plain C interface, which is loaded with ctypes. The library
goes to `sealdnerf_tpu_torch/_build/<hash>/`, keyed by a hash of the flags
and of every file under `ops/csrc/` (sources and the headers they include),
so an unchanged tree builds once and an edited header rebuilds.

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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sorted(q for q in SRC_DIR.iterdir() if q.is_file()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the build directory (once per source hash)
    and return the library's path. One nvcc per source, all started
    together, then one link. nvcc's output, with the per-kernel register
    and shared-memory report, is kept beside the library in nvcc.log."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    jobs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{tag}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        log.append(f"== {src.name}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(f"{src.name} (code {proc.returncode})")
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    if not failed:
        res = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                              *(str(obj) for _, obj, _ in jobs)],
                             capture_output=True, text=True)
        log.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append(f"link (code {res.returncode})")
    (out_dir / "nvcc.log").write_text("".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n"
                           f"{''.join(log)[-4000:]}")
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
                                  i32, i32, vp, vp, vp]
    lib.sdn_field_fwd.restype = ctypes.c_int
    lib.sdn_field_bwd.argtypes = [vp, vp, vp, i64, vp, vp, vp,
                                  ctypes.POINTER(ctypes.c_longlong), f32,
                                  vp, vp, vp, vp, vp, vp]
    lib.sdn_field_bwd.restype = ctypes.c_int
    lib.sdn_dyn_field_fwd.argtypes = [vp, vp, i64, vp, vp,
                                      ctypes.POINTER(ctypes.c_longlong), f32,
                                      vp, ctypes.POINTER(ctypes.c_longlong),
                                      vp, i32, i32, vp, vp, vp, vp]
    lib.sdn_dyn_field_fwd.restype = ctypes.c_int
    lib.sdn_dyn_field_bwd.argtypes = (
        [vp, vp, vp, i64, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong), f32,
         vp, ctypes.POINTER(ctypes.c_longlong), vp, i32, i32]
        + [vp] * 11 + [i64, i32, vp, vp])
    lib.sdn_dyn_field_bwd.restype = ctypes.c_int
    return lib
