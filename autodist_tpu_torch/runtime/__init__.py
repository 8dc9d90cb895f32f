"""Host runtime pieces: the shared retry policy, the fault vocabulary
the checkpoint layer records into, and the native data-IO library."""
