"""Measurements of the card itself that the kernels' designs rest on."""
