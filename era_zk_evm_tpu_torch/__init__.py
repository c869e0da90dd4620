"""era_zk_evm_tpu_torch — the PyTorch + CUDA port of era_zk_evm_tpu.

Runs the batched EraVM interpreter on an NVIDIA H100: plain torch code for
everything around the kernels, and hand-written CUDA kernels (`csrc/`) for
the cycle interpreter (K1) and the rolling-commitment fold (K2).  It
imports torch and never jax; the JAX package stays the reference, and only
its jax-free layers (`isa`, `golden`, `utils`) are shared.  Importing the
package builds nothing: the kernels compile on first use (`_build.py`).
"""
