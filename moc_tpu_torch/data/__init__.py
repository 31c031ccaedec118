"""moc_tpu_torch.data — bag IO, padding/bucketing and synthetic bags."""

from moc_tpu_torch.data.bags import Bag, read_bag_h5, read_bag_pt
from moc_tpu_torch.data.batching import (DEFAULT_BUCKETS, BagBatch, bucket_size,
                                         bucketize, pack_bags, pad_bag)

__all__ = ["Bag", "BagBatch", "DEFAULT_BUCKETS", "bucket_size", "bucketize",
           "pack_bags", "pad_bag", "read_bag_h5", "read_bag_pt"]
