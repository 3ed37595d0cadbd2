"""Evaluation-side pieces of the port: so far the detector checkpoint restore."""
