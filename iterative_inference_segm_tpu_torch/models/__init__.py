"""FCN-8 segmenter, the conditional DAE score network and the score-network
registry (port)."""
