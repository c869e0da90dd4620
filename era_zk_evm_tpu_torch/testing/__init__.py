"""Programs for driving the port without the JAX package's tests."""
