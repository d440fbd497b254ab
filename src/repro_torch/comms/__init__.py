"""The compressed gradient exchange: bucketing, transport, reducers."""
