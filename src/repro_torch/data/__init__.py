"""Seekable synthetic corpus and loader (a copy of the reference's)."""
