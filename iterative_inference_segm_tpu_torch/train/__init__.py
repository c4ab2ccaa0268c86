"""DAE training (the frozen FCN-8 + corruption + score network step) and
its scaffold."""
