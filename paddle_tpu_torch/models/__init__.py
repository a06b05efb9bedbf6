"""Models of the port (see :mod:`.transformer`)."""
