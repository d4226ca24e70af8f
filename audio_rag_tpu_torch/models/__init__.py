"""Model definitions of the port (params as dicts of tensors)."""
