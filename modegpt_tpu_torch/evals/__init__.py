"""Perplexity evaluation."""
