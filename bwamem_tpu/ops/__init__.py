"""Compute kernels. Each op ships as twins sharing one semantics:

  *_ref.py       — scalar numpy golden reference (the "software model")
  *_jax.py       — batched vectorized pure-JAX (any backend)
  extend_step.py — the extension step per platform: a CUDA kernel
                   (jax.ffi) on NVIDIA GPUs, the plain XLA step on the CPU

This mirrors the reference's verification story (SURVEY.md §4): the FPGA ran
the same host against an RTL simulator (ASE) or real hardware behind one
swappable transport; here the kernel/jax/ref twins sit behind one interface
and are fuzz-tested against each other.
"""
