"""Calibration data loading and Gram/BI statistics."""
