"""Evaluation harnesses: perplexity, yes/no accuracy, compression metrics
and plots."""
