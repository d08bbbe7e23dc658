"""Checkpoints of (compressed) model params; phase timers, the profiler
trace scope and the event log."""
