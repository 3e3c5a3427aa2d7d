"""Compute stages of the pipeline, in plain jax.numpy / lax."""
