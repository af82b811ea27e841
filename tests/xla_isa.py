"""The vector instructions XLA's CPU code is compiled for here, and the test
of a result that depends on them.

XLA compiles the JAX package's jitted functions for the host's widest vector
instruction set unless ``XLA_FLAGS`` caps it (``--xla_cpu_max_isa``).  At some
shapes the bits of the compiled packed warp depend on that choice: an AVX2
build and an AVX-512 build of the same function give different last bits.
The port follows the AVX-512 build's answer there.  A test of such a case
records the SHA-256 of that answer's float32 bytes, holds the port's output
to it on every host, and where XLA compiles for AVX-512 also holds JAX's
output to it, so the record stays XLA's answer; elsewhere it holds the port
within a tolerance of JAX's local answer.  ``XLA_FLAGS=--xla_cpu_max_isa=AVX2``
runs the second branch on an AVX-512 host.
"""

import hashlib
import os
import re

import numpy as np


def _host_has_avx512() -> bool:
    try:
        with open("/proc/cpuinfo") as f:
            return "avx512f" in f.read()
    except OSError:
        return False


def _capped_below_avx512(flags: str) -> bool:
    found = re.findall(r"--xla_cpu_max_isa=(\w+)", flags)
    return bool(found) and not found[-1].upper().startswith("AVX512")


XLA_AVX512 = _host_has_avx512() and not _capped_below_avx512(os.environ.get("XLA_FLAGS", ""))


def digest(a) -> str:
    """SHA-256 of an array's float32 bytes in C order."""
    return hashlib.sha256(np.ascontiguousarray(a, dtype=np.float32).tobytes()).hexdigest()


def hold_to_recorded(got, want, recorded: str, atol: float) -> None:
    """``got`` (the port's output) has the ``recorded`` digest of the AVX-512
    build's answer; ``want`` (JAX's jitted output here) has it too where XLA
    compiles for AVX-512, else ``got`` is within ``atol`` of it."""
    assert digest(got) == recorded
    if XLA_AVX512:
        assert digest(want) == recorded
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
