"""Stream-parallel DATMO on one card (``streams``), the counterpart of
``datmo_using_optical_flow_tpu.parallel``.  The row-sharded flow (JAX
``parallel/halo.py``, ``sharded_flow.py``, ``mesh.py``) has no counterpart
yet."""
