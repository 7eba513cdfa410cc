"""Launcher-level runtime of the port: the fault-tolerance controller."""
