"""Framework-free helpers and the weight bridge to the JAX package."""
