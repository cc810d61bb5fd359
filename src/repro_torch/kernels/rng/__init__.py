"""The counter draw on the card: ``kernel.py`` (``csrc/rng.cu``)."""
