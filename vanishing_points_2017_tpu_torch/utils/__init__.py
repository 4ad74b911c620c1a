"""Support code of the port: tracing, stage timing and logging."""
