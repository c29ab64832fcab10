"""Build of the port's CUDA sources (``cambrian_tpu_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` for sm_90a into a shared library with a
plain C interface, which its op module loads with ctypes. Libraries go to
``build/cambrian_tpu_torch/`` at the repository root, under a file name keyed
by a hash of the source and the flags, so an edited source rebuilds. Nothing
is compiled at import time; ``build`` starts one ``nvcc`` per missing
library, all at once, and waits for them.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cambrian_tpu_torch"
# the dtype argument every kernel's C interface takes
DTYPE_CODES = {"float32": 0, "bfloat16": 1}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def library_path(name: str) -> Path:
    """Where the library of ``csrc/{name}.cu`` lives once built. The hash
    covers the source, the ``csrc/*.cuh`` headers it includes, and the
    flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = sorted(set(re.findall(rb'#include "([\w.]+\.cuh)"', src)))
    for header in headers:
        src += (CSRC / header.decode()).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def build(*names: str) -> Dict[str, dict]:
    """Compile the libraries of ``csrc/{name}.cu`` that are not built yet,
    in parallel. Returns ``{name: {"path", "seconds", "log"}}``; ``log``
    holds nvcc's output (ptxas register and shared-memory use) for a library
    this call compiled. Raises if nvcc is missing or any compile fails."""
    out, jobs = {}, {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0, "log": ""}
            continue
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: csrc/{name}.cu needs the CUDA toolkit")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": str(path), "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build ``csrc/{name}.cu`` if needed and load it with ctypes. Each entry
    of ``signatures`` gives a C function's argument types; every one returns
    a cudaError_t as an int, which ``cambrian_cuda_error_string`` names."""
    lib = ctypes.CDLL(build(name)[name]["path"])
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.cambrian_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cambrian_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.cambrian_cuda_error_string(err).decode()}")


def on_cpu(t, name: str) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA one
    (the kernel runs); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return False


def dtype_code(t) -> int:
    """The C interfaces' code for a tensor's dtype (float32 or bfloat16)."""
    return DTYPE_CODES[str(t.dtype).replace("torch.", "")]
