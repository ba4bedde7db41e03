"""Serving programs of the static-batch path (``serve_step``)."""
