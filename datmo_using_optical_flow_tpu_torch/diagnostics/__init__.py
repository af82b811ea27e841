"""Diagnostics of the port on the card, the counterparts of the JAX package's
``benchmarks/micro_flow.py``, ``profile_1080p.py`` and ``diag_icp_body.py``.

Each module's ``run(...)`` takes its frames or clouds as arguments, runs on
``cuda`` unless it is given ``device="cpu"``, prints one line per row with the
card's name and power limit, and returns the rows.  ``roofline`` holds each
kernel's byte and operation counts and its bound on the H100.  Run one on the
card with ``python -m datmo_using_optical_flow_tpu_torch.diagnostics.micro_flow``.
"""
