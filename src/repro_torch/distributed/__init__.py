"""Fault-tolerance policy shared by the replicated serve tier."""
