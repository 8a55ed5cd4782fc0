"""Training: optimizer and learners."""
