"""FCN-8 segmenter and the conditional DAE score network (port)."""
