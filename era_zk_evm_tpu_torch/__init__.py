"""era_zk_evm_tpu_torch — the PyTorch + CUDA port of era_zk_evm_tpu.

Runs the batched EraVM interpreter and its witness commitments on an NVIDIA
H100: plain torch code for everything around the kernels, and hand-written
CUDA kernels (`csrc/`) for the cycle interpreter (K1), the rolling-commitment
fold (K2) and chained keccak-f[1600] (K3).  It imports torch and never jax,
and nothing of the JAX package: it keeps its own copy of the ISA layer
(`isa/`) and of the constants and programs it needs, each held equal to the
original by a test.  The JAX package stays the reference.  Importing the
package builds nothing: the kernels compile on first use (`_build.py`).
"""
