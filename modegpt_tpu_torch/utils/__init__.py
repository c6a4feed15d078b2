"""Small helpers: device selection, logging, the metrics registry."""
