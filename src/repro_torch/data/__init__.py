"""Synthetic data: the copy task and the Zipf–Markov corpus."""
