"""Launchers of the port: the host mesh and ``serve --sam``."""
