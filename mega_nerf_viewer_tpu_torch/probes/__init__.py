"""Microbenchmarks of the card (the row-gather probe, kernel H)."""
