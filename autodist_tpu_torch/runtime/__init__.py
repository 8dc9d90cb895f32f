"""Host runtime pieces: the shared retry policy, the fault vocabulary
the checkpoint layer records into, the native data-IO library and the
coordination service (``coordination.py`` over ``native/coord.cc``)."""
