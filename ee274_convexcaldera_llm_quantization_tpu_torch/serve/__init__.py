"""Serving: sampling and the continuous-batching engines."""
