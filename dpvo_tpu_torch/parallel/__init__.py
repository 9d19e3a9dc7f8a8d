"""The training step on one GPU (``train_step``).  The data-parallel mesh
of the JAX package's ``parallel/`` is not ported yet (ROADMAP.md)."""
