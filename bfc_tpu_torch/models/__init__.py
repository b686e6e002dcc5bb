"""Counting, correction and the end-to-end pipeline."""
