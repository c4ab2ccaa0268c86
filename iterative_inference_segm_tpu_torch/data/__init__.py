"""Dataset constants, synthetic scenes and on-device preprocessing."""
