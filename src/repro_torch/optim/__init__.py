"""Optimizers, the learning-rate schedule and gradient compression for LM
training: the JAX package's ``optim``."""
