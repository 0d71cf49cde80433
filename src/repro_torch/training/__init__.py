"""Training of the port: AdamW, the LM loss and train step, and flat-file
checkpoints, held to the JAX package's ``training``."""
