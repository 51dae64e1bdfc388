"""Utilities shared by the port's ops and models."""
