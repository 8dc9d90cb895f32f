"""Parallel building blocks of the port (tensor parallel 1 so far)."""
