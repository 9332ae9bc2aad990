"""The serving plane's admission queue (``batcher.py``)."""
