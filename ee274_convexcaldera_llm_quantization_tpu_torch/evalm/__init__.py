"""Evaluation harnesses (perplexity)."""
