"""Host runtime: the native ``.chunk`` decoder (``native.py``)."""
