"""Restart files and VTU output."""
