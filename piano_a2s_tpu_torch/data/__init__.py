"""Dataset metadata (the time-signature table)."""
