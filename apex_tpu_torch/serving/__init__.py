"""Serving pieces of the port (paged KV pool)."""
