"""The port's data pipeline (``pipeline``)."""
