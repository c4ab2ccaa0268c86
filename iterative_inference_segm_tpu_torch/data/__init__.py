"""Dataset constants and preprocessing needed by the serving path."""
