"""Checkpoints (flat npz, training state), the JAX-parameter bridge and
experiment logging."""
