"""Evaluation: a grid of settings through the whole pipeline,
with the reference's outputs (run_evaluation.py)."""
