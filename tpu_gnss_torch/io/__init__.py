"""Capture sources."""
