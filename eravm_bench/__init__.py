"""The benchmark of the PyTorch + CUDA port of EraVM (`era_zk_evm_tpu_torch`)
on an NVIDIA H100: `python -m eravm_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` (run.py).  The harness takes its cells from
`BENCHMARK.json` at the repository's root and its configurations, traffic
mixes and per-layer readers from files of their own (configs/, traffic/,
metrics/); reference/ holds the plain reference that decides `correct`."""
