"""Vector store of the port."""
