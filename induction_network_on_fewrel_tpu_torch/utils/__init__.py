"""Host-side utilities: the metrics logger."""
