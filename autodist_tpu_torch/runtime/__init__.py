"""Host runtime pieces: the shared retry policy, the launcher and its
supervision (``cluster.py``), fault plans and their injector
(``faults.py``), the native data-IO library and the coordination
service (``coordination.py`` over ``native/coord.cc``)."""
