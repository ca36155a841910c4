"""Checkpoint store of the iterated loops (``store``): the JAX package's
on-disk format, so either package restores the other's checkpoints."""
