"""Build and load the port's CUDA kernels (nvcc by hand, bound with ctypes).

The sources are ``csrc/*.cu`` of this package.  They are compiled for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface, named by a hash of
the sources and flags, under ``build/kernels/`` of the checkout.  The build
runs at the first CUDA use, takes seconds, and is reused while the sources are
unchanged.  There is no fallback: a missing ``nvcc`` or a failed build raises.

``-fmad=false`` keeps every multiply and add separately rounded, as PyTorch's
elementwise ops round them, so each kernel can be held to its plain PyTorch
version at the same tolerance as the CPU tests hold that version to the JAX
kernel (the near-singular 2x2 solves at attenuated border pixels amplify a
one-ulp change in M by ~1000x).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of csrc/*.cu: (argtypes, restype)
_SIGNATURES = {
    "datmo_poly_exp": ([_P, _P, _I, _I, _I, _P, _P, _P, _P, _P], _I),
    "datmo_blur_solve": ([_P, _P, _P, _I, _I, _P, _I, _F, _P], _I),
    "datmo_fused_iteration": ([_P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _F, _P], _I),
    "datmo_nn_sweep": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _F,
                        _F, _P], _I),
    "datmo_error_string": ([_I], ctypes.c_char_p),
}


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under PyTorch's ``CUDA_HOME``; raises if neither."""
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(cand) if cand.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                           "the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdatmo_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the library if it is not built yet.

    Returns ``(path, seconds, compiler output)``; seconds is 0.0 and the output
    is the saved build log when the library already existed.
    """
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        return out, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(_sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        outputs = [proc.communicate()[0] for proc in procs]  # waits for every process
        text = "".join(outputs)
        for cmd, proc, output in zip(cmds, procs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{output}")
        lib_tmp = os.path.join(tmpdir, out.name)
        link = [nvcc, "-shared", "-o", lib_tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        text += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{text}")
        log.write_text(text)
        os.replace(lib_tmp, out)  # atomic: a reader never sees a half-written library
    return out, time.perf_counter() - t0, text


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built library, loaded once per process, with its C signatures set."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its cudaGetLastError)."""
    if err != 0:
        msg = library().datmo_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
