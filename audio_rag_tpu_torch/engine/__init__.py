"""The port's batched query engine."""
