"""The LM substrate's models: layers, decoder-only assembly, weights carried
across from the JAX package."""
