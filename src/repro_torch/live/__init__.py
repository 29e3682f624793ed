"""On-disk index format (single-segment v2 manifest, v1 read)."""
