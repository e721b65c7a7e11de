"""Generators and batched synthesis."""
