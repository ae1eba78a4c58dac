"""Serve step and image detector."""
