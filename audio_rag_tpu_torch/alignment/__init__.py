"""Word → speaker alignment of the port."""
