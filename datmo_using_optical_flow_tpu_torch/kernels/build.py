"""Build, load and launch the port's CUDA kernels (nvcc by hand, bound with
ctypes).

The sources are ``csrc/*.cu`` of this package (with the headers
``csrc/*.cuh`` they include).  They are compiled for Hopper
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

Every wrapper launches through one :class:`Entry` per C entry point: the
function and its argument types are resolved once, the stream is read as a
raw integer, and the device switch happens in C (``csrc/device_guard.cuh``),
so a launch costs one ctypes call and no Python device context.
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

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of csrc/*.cu: (argtypes, restype).  Each kernel's entry ends
# with the device index and the stream.
_NN_SWEEP = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _F, _F]
_SIGNATURES = {
    "datmo_poly_exp": ([_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P], _I),
    "datmo_poly_exp_tiny": ([_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P], _I),
    "datmo_blur_solve": ([_P, _P, _P, _P, _I, _I, _P, _I, _F, _I, _P], _I),
    "datmo_fused_iteration": ([_P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _P, _I, _F,
                               _I, _P], _I),
    "datmo_nn_sweep": ([*_NN_SWEEP, _I, _P], _I),
    "datmo_nn_sweep_active": ([*_NN_SWEEP, _I, _P], _I),
    "datmo_nn_sweep_sized": ([*_NN_SWEEP, _I, _I, _P], _I),
    "datmo_warp_matrices": ([_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P], _I),
    "datmo_warp_packed": ([_P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _P], _I),
    "datmo_corner_scale": ([_P, _P, _I, _I, _I, _P], _I),
    "datmo_tiny": ([_P, _P, ctypes.c_int64, _I, _P], _I),
    "datmo_fma32": ([_P, _P, _P, _P, _F, _F, _I, *[ctypes.c_int64] * 12, _I, _I, _P], _I),
    "datmo_transform_points": ([_P, _P, _P, *[ctypes.c_int64] * 5, _I, _P], _I),
    "datmo_sumsq": ([_P, _P, _P, _I, _I, *[ctypes.c_int64] * 8, _I, _P], _I),
    "datmo_level_images": ([_P, _P, _I, _I, _P, _I, _I, _I, _P], _I),
    "datmo_resize": ([_P, _P, _P, ctypes.c_int64, _I, _I, _I, _I, _I, _P, _F, _I, _P], _I),
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
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
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


class Entry:
    """A kernel's C entry point, launched on the current stream of a device.

    ``entry(device_index, *args)`` calls the C function with ``args``, the
    device index and that device's current stream (a raw integer), and
    raises through :func:`check` on a nonzero return.  The function, with its
    argument types, is resolved at the first call, which builds and loads the
    library; so is ``torch._C._cuda_getCurrentRawStream``, which only CUDA
    builds of torch have.
    """

    __slots__ = ("name", "what", "_fn", "_stream")

    def __init__(self, name: str, what: str):
        if name not in _SIGNATURES:
            raise KeyError(f"no C entry point {name}")
        self.name, self.what = name, what
        self._fn = self._stream = None

    def resolve(self) -> tuple:
        """The ctypes function and the raw-stream lookup, resolved once."""
        if self._fn is None:
            self._stream = torch._C._cuda_getCurrentRawStream
            self._fn = getattr(library(), self.name)
        return self._fn, self._stream

    def __call__(self, device_index: int, *args) -> None:
        fn = self._fn
        if fn is None:
            fn = self.resolve()[0]
        err = fn(*args, device_index, self._stream(device_index))
        if err:
            check(err, self.what)
