"""Device selection and the float32 matmul precision the port relies on.

TF32 is switched off for every float32 matmul and convolution when this module
is imported.  DBSCAN's expanded distance ``|x|^2 + |t|^2 - 2 x.t`` works on
grid coordinates up to ~2000, where float32 already rounds the squared distance
by up to 0.5 against ``eps^2 = 25``; TF32's 10-bit mantissa would be ~1000x
worse and change which cells are neighbours.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device) -> torch.device:
    """The explicit ``device`` as a ``torch.device``; raises when CUDA is asked
    for and no CUDA device is present (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    return dev
