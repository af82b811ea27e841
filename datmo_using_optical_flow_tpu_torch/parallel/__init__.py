"""Multi-stream and multi-rank DATMO, the counterpart of
``datmo_using_optical_flow_tpu.parallel``: several feeds on one card
(``streams``), and the flow grid sharded by rows over the ranks of a
``torch.distributed`` group (``mesh``: the group and its process set-up;
``halo``: the halo exchange and the sharded stencils; ``sharded_flow``: the
sharded pyramid)."""
