"""Data-transfer objects."""
