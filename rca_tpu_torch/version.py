"""The port's version, stamped into every recording's header."""

__version__ = "0.1.0"
