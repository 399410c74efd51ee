"""Work counts: the peaks and counts (h100.py), one file per configuration."""
