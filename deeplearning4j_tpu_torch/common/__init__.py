"""Shared config plumbing: the JSON serde copy (``common.serde``)."""
