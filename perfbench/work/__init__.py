"""The benchmark's frozen counts and peaks (``counts``)."""
