"""Failure injection."""
