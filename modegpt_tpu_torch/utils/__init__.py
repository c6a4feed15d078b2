"""Small helpers: device selection, device memory, logging, the metrics registry."""
