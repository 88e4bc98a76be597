"""Carrying weights into the port: from the JAX package (``from_jax``) and
from the original PyTorch OpenViIC's runs (``torch_import``, ``migrate``)."""
