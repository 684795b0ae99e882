"""Launchers (port of ``repro.launch``): the serving driver ``serve``."""
