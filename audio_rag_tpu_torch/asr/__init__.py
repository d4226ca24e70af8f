"""ASR backend of the port."""
