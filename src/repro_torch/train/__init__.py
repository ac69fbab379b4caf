"""LM serving of the port: prefill and decode steps, greedy generation."""
