"""Checkpoint loading (training itself is a later slice)."""
