"""Lowering a compiled strategy into a distributed training step."""
