"""Core of the port: index build and query path."""
