"""Framework-free serving core (copies of the JAX package's modules) plus
the partial-softmax combine."""
