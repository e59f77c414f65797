"""Training and evaluation runtime of the port."""
