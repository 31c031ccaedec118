"""moc_tpu_torch.data — slide tables, splits, bag IO, padding/bucketing,
episode loading and synthetic corpora."""

from moc_tpu_torch.data.bags import Bag, bag_patch_count, read_bag, read_bag_h5, read_bag_pt
from moc_tpu_torch.data.batching import (DEFAULT_BUCKETS, BagBatch, bucket_size,
                                         bucketize, pack_bags, pad_bag)
from moc_tpu_torch.data.loader import BagLoader, EpisodeBags
from moc_tpu_torch.data.splits import (Split, generate_fewshot_splits, read_split_csv,
                                       write_split_csv)
from moc_tpu_torch.data.synthetic import make_synthetic_corpus
from moc_tpu_torch.data.table import SlideTable

__all__ = ["Bag", "BagBatch", "BagLoader", "DEFAULT_BUCKETS", "EpisodeBags", "SlideTable",
           "Split", "bag_patch_count", "bucket_size", "bucketize", "generate_fewshot_splits",
           "make_synthetic_corpus", "pack_bags", "pad_bag", "read_bag", "read_bag_h5",
           "read_bag_pt", "read_split_csv", "write_split_csv"]
