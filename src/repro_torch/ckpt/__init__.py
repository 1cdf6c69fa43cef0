"""Checkpoints of the training state, in the JAX package's on-disk layout."""
