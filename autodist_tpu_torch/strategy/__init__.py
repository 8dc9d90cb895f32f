"""The Strategy IR's serving knobs (the normalizers the engine reads)."""
