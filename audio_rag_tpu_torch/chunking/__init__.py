"""Transcript chunking of the port."""
