"""Kernel-backed ops of the port (see each module)."""
