"""Carrying weights from the JAX package into the port."""
