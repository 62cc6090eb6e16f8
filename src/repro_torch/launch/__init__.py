"""Launchers of the port: the host mesh and ``serve`` (the language-model
mode and ``--sam``)."""
