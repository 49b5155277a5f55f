"""Reconstruction step (single device)."""
