"""EgoM2P in PyTorch for one NVIDIA H100: the port of egom2p_tpu.

Same layout as the JAX package (ops/, models/, tokenizers/cosmos/,
generate/, compat/, cli/), written in PyTorch.  Each Pallas TPU kernel on
the ported path is a hand-written Hopper kernel under csrc/, built by nvcc
at first use (ops/_build.py).  The package imports no JAX.
"""
