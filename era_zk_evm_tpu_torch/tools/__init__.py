"""The tool probes of `tools/` on the card: each runs a hand-written CUDA
kernel (`csrc/probe_keccak.cu`, `probe_rate.cu`, `probe_uniform.cu`,
`bisect_fold.cu`) beside its plain torch version, and has a `main(argv)`
that takes the JAX tool's variant names.  Run as
`python -m era_zk_evm_tpu_torch.tools.<module> [variant ...] [--cpu]`."""
