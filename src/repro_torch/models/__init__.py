"""LM layers and the dense decoder model of the port."""
