"""Model definitions of the port (the pipelined transformer LM so far)."""
