"""Batched VM state, the plain cycle step, the kernel dispatcher, the
lane-refill scheduler."""
