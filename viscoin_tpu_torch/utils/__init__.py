"""Weight carrying between the JAX package and the port."""
