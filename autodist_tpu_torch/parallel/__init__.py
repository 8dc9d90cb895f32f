"""Parallel building blocks of the port."""
