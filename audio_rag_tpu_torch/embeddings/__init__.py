"""Embedders of the port."""
