"""The port's copy of presto_tpu/protocol: for now the page frames of
serde.py that spill files use."""
