"""Model layers of the port (counterparts of ``repro.models``)."""
