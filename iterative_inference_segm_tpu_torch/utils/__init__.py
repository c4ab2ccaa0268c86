"""Checkpoint (flat npz) and JAX-parameter bridge."""
