"""Metrics and testers."""
