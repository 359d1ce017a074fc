"""Work over several beams or devices (the JAX package's parallel/); one
device so far."""
