"""Host utilities of the port: the project logger."""
