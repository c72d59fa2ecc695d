"""Measurement tools of the port; each runs on the GPU as a module (``python -m``)."""
