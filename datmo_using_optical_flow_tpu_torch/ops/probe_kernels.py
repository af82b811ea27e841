"""The launch-cost probe (K6): ``x + 1`` as a CUDA kernel, its plain version
and its launch counter.

The counterpart of ``tiny_pallas`` in the JAX package's ICP-round diagnostic
(``benchmarks/diag_icp_body.py``), which times one kernel launch per loop
step.  :func:`tiny` dispatches on its input's device alone: a CPU tensor takes
:func:`tiny_reference`, a CUDA tensor launches the kernel of
``csrc/probe_kernels.cu`` on the current stream, and any other device raises.
"""

from __future__ import annotations

import torch

from datmo_using_optical_flow_tpu_torch.kernels import build
from datmo_using_optical_flow_tpu_torch.ops.flow_kernels import _on_cuda

LAUNCHES = {"tiny": 0}


def reset_launches() -> None:
    LAUNCHES["tiny"] = 0


def tiny_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K6."""
    return x + 1.0


def tiny(x: torch.Tensor) -> torch.Tensor:
    """K6: ``x + 1`` for a contiguous float32 tensor of any shape."""
    if x.dtype != torch.float32:
        raise TypeError(f"x: expected float32, got {x.dtype}")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError("x: expected a non-empty contiguous tensor")
    if not _on_cuda(x):
        return tiny_reference(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = build.library().datmo_tiny(out.data_ptr(), x.data_ptr(), x.numel(),
                                         torch.cuda.current_stream().cuda_stream)
    build.check(err, "tiny")
    LAUNCHES["tiny"] += 1
    return out
