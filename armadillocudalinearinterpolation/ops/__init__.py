"""Standalone ops: batched interpolation (plain jnp, XLA-compiled)."""
