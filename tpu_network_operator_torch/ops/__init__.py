"""Ops of the port: RoPE, plain attention, and the two hand-written CUDA
kernels (RMSNorm forward, flash-attention forward) with their plain
versions."""
