"""Offline tools of the port."""
