"""PyTorch/CUDA port of pipeline A's streaming step (BEV flow DATMO).

The JAX package ``datmo_using_optical_flow_tpu`` is the reference this package
is held to; module names and layouts mirror it.  Plain tensor code is PyTorch;
the three Farnebäck kernels of the flow are hand-written CUDA for Hopper
(``csrc/flow_kernels.cu``, bound by ``ops/flow_kernels.py``).  Nothing here
imports JAX or yaml.
"""
