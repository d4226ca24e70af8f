"""Data model and error types of the port."""
