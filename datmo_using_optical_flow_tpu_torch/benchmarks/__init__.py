"""The port's benchmarks: each prints its JAX counterpart's JSON line, measured on the card."""
