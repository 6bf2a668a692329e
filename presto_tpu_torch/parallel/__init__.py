"""The port's copy of presto_tpu/parallel: for now only the aggregate
split of dist.py, which bounded execution (exec/lifespan.py) needs on one
device."""
