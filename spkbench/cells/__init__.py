"""Drivers, one a ``system`` a configuration can name (``cells/<system>.py``)."""
