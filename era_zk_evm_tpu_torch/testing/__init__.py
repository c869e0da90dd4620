"""Programs for driving the port without the JAX package's tests, the
golden-backed harness (`harness.py`, `differential.py`) and the debug
trace."""
