"""Fixed-capacity compaction, the counterpart of
``datmo_using_optical_flow_tpu.utils.padding.compact_masked``.

Every buffer has a static capacity and a validity mask; compaction moves the
valid rows to the front in input order (like numpy boolean indexing).  One
cumsum and one scatter, with no host synchronisation (``nonzero`` would wait
for the device to learn the output size).  The JAX package's bitpacked rank
search works around a slow ``top_k`` on the TPU and has no counterpart here.
"""

from __future__ import annotations

import torch


def compact_masked(x: torch.Tensor, mask: torch.Tensor, capacity: int,
                   fill_value=1e9) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable-compact rows of ``x`` where ``mask`` is True into ``(capacity, ...)``.

    Returns ``(compacted, out_mask, count)``: the first ``capacity`` valid rows
    in input order, padded with ``fill_value``; ``count`` (0-d int32) is the
    number of valid rows, clamped to ``capacity``.
    """
    mask = mask.to(torch.bool)
    pos = torch.cumsum(mask.to(torch.int64), dim=0) - 1   # destination row of valid entries
    count = torch.clamp(pos[-1] + 1, max=capacity).to(torch.int32)
    dest = torch.where(mask & (pos < capacity), pos, capacity)  # others -> dropped slot
    out = torch.full((capacity + 1,) + tuple(x.shape[1:]), fill_value, dtype=x.dtype,
                     device=x.device)
    out[dest] = x
    out_mask = torch.arange(capacity, device=x.device) < count
    return out[:capacity], out_mask, count
