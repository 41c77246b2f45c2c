"""Roofline cost model of the port (H100 constants)."""
