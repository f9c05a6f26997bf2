"""Self-contained recipe scripts of the port (twins of ``recipes/*.py``)."""
