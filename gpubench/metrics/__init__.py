"""One reader a per-layer metric: ``<metric name>.py`` with ``read(layer)``
returning the value, or None where it finds nothing to read."""
