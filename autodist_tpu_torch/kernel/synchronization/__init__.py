"""Gradient synchronization: the bucket planner."""
