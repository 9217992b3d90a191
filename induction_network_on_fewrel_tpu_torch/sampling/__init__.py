"""Episode samplers (numpy, host side)."""
