"""Device-mesh parallelism: query sharding, the multi-device build and the
row-sharded index, on PyTorch devices and ``torch.distributed``."""
