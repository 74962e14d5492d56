"""Timing helpers of the port (``bench/harness.py``)."""
