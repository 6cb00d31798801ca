"""Build and load the CUDA kernels: ``nvcc`` by hand into one shared library
with a plain C interface, loaded with ``ctypes``.

The library is built at first use from the sources under ``csrc/`` and
nothing else: one ``nvcc -c`` per source, all started together, then one
link.  PyTorch's headers are not involved, so the build takes seconds.  It
lands in ``build/`` at the repository root (or ``$REPRO_TORCH_BUILD_DIR``),
under a name keyed by the sources' content, so an edited source never meets a
stale library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib = None
build_seconds = 0.0     # wall time of the last real build in this process


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> repository root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME): the CUDA "
                       "kernels cannot be built on this machine")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _key(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    failed = None
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode and failed is None:
            failed = (c, p.returncode, out)
    if failed:
        raise RuntimeError(f"{' '.join(failed[0])} exited {failed[1]}:\n"
                           f"{failed[2]}")
    return "".join(logs)


def build(verbose: bool = False) -> Path:
    """Compile the library if its keyed file is not there yet; return it."""
    global build_seconds
    srcs = sources()
    out_dir = build_dir()
    lib = out_dir / f"librepro_torch_kernels_{_key(srcs)}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objs = [out_dir / f"{p.stem}.{tag}.o" for p in srcs]
    extra = ["-Xptxas", "-v"] if verbose else []
    log = _run_all([[nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", str(p),
                     "-o", str(o)] for p, o in zip(srcs, objs)])
    tmp = out_dir / f"{lib.name}.{tag}.tmp"
    log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, lib)     # atomic: a concurrent build sees all or nothing
    for o in objs:
        o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    if verbose:
        print(log, file=sys.stderr)
    return lib


def load(verbose: bool = False) -> ctypes.CDLL:
    """The loaded library (built on first call), argument types set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build(verbose)))
        vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_float)
        lib.dps_group_wire_encode.restype = i32
        lib.dps_group_wire_encode.argtypes = [
            vp, i32, vp, vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, vp]
        lib.paged_decode_attn.restype = i32
        lib.paged_decode_attn.argtypes = [
            vp, vp, vp, i32, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
            f32, vp]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [i32]
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
