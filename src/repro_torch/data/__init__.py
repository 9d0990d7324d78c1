"""The synthetic token stream training reads (``pipeline``)."""
