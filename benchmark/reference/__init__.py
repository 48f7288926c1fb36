"""The plain reference of the benchmark's correctness check (see drive.py).

A frozen copy of the port's plain math: plain PyTorch, no hand-written
kernel, and nothing imported from the port or the JAX package."""
