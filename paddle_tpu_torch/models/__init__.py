"""Models of the port (see :mod:`.transformer` and :mod:`.mnist`)."""
