"""Host-side audio I/O and the synthetic charvoice."""
