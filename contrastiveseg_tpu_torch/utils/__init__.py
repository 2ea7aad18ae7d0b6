"""Utilities of the port: the config tree and the weights bridge from the
JAX package."""
