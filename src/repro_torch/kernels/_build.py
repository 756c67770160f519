"""Build the CUDA sources under `csrc/` with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the sources (the .cu and every .cuh
beside it) and the flags, so an edit rebuilds and a rerun reuses the
build. The build happens at first use, or up front for every kernel at
once with `build_all()` (one nvcc process per source, all started
together). A build that fails raises; nothing falls back to the plain
versions. `_build/` is listed in .gitignore.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("nestedfp16_matmul", "nestedfp8_matmul", "f16_matmul",
           "paged_planar_decode_attention", "planar_decode_attention",
           "flash_prefill_attention", "nestedfp8_matmul_fused_quant",
           "nestedfp_encode", "quant_per_token")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built with nvcc on the machine with the GPU")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build_all(names=KERNELS) -> dict[str, Path]:
    """Compile every named kernel that has no current build, one nvcc per
    source, all running at once. Returns name -> library path; raises
    RuntimeError with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names}
    procs = {}
    for n, path in todo.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, path)
    failed = []
    for n, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {n} (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return todo


def build_log(name: str) -> str:
    """nvcc's output (register and shared-memory use from -Xptxas=-v) of
    the current build of `name`, or '' when it was built elsewhere."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def function(lib_name: str, fn_name: str, argtypes) -> object:
    """The C entry point `fn_name` of kernel library `lib_name`, built on
    first use, with its argument types declared (pointers and the stream
    as c_void_p, so they are never cut to 32 bits) and an int return: the
    cudaError_t of the launch."""
    key = (lib_name, fn_name)
    with _lock:
        if key not in _fns:
            if lib_name not in _libs:
                path = build_all((lib_name,))[lib_name]
                _libs[lib_name] = ctypes.CDLL(str(path))
            fn = getattr(_libs[lib_name], fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[key] = fn
        return _fns[key]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
