"""Data parallelism over a list of devices (port of yolo_tpu/parallel):
the batch split into equal shards, one replica of the weights per
device, the whole batch's training step (parallel/sharding.py)."""
