"""Synthetic hybrid datasets (numpy; the same draws as the reference)."""
