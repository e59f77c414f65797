"""Evaluation runtime of the port."""
