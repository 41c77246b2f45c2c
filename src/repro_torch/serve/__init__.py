"""Subpackage."""
