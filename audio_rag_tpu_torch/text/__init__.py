"""Tokenizers of the port."""
