"""Attention, RoPE and the hand-written CUDA kernels of the port."""
