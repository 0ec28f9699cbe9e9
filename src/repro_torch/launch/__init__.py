"""Drivers of the port: the real-model serving entry point."""
