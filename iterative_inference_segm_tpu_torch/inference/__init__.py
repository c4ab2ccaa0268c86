"""The pooled-scale (half / quarter) refinement engine and the serving
``Predictor`` (port)."""
