"""One reader a per-layer metric, ``<metric>.py``, found by the metric's
name: ``read(context)`` takes the number from what a ``--trace 1`` run
gathered (``runners/<family>.py`` says what) and returns it, or None
where there is nothing to read, and the metric is then left out of the
line. A share of a roofline or a peak is never returned as 0."""
