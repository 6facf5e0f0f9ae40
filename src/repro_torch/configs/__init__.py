"""Architecture configurations the port runs, copied from the JAX package."""
