"""The port's engine: the device ledger (``engine.py``), the batched query
engine, the generation schedulers and the query coalescer."""
