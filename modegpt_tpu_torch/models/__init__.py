"""Model specification, the functional forward with calibration taps, and weight loading."""
