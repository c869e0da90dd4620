"""era_zk_evm_tpu_torch — the PyTorch + CUDA port of era_zk_evm_tpu.

Runs the batched EraVM interpreter and its witness commitments on an NVIDIA
H100: plain torch code for everything around the kernels, and hand-written
CUDA kernels (`csrc/`) for the cycle interpreter (K1, with the keccak256,
sha256 and ecrecover precompile units), the rolling-commitment fold (K2),
chained keccak-f[1600] (K3) and the tool probes P1-P7 (`tools/`).  The product entry point is `block.execute_block`: a
block of transactions over a lane-refilling scheduler, with per-tx and block
commitments; `parallel/` shards the lanes over a mesh of devices.  It
imports torch and never jax, and nothing of the JAX package: it keeps its
own copy of the ISA layer (`isa/`), of the golden oracle (`golden/`) and
of the programs it needs, each held equal to the original by a test.  The JAX package stays the reference.  Importing the
package builds nothing: the kernels compile on first use (`_build.py`).
"""
