"""Drivers of the traffic modes, one a mode."""
