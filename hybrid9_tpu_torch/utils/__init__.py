"""Utilities: logging."""
