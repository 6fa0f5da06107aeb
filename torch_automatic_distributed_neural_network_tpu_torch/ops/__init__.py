"""Attention operators: the reference einsum attention and the paged
decode kernel (CUDA C++ for Hopper, built from ``csrc/`` at first use)."""
