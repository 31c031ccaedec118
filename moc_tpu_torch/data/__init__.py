"""moc_tpu_torch.data — slide tables, splits, bag IO, padding/bucketing,
episode loading, dual-scale (ViLa) bags and synthetic corpora."""

from moc_tpu_torch.data.bags import (Bag, bag_patch_count, load_pkl, read_bag, read_bag_h5,
                                    read_bag_pt, save_pkl)
from moc_tpu_torch.data.batching import (DEFAULT_BUCKETS, BagBatch, bucket_size,
                                         bucketize, pack_bags, pad_bag)
from moc_tpu_torch.data.loader import BagLoader, EpisodeBags, prefetch_to_device
from moc_tpu_torch.data.splits import (Split, generate_fewshot_splits, generate_splits,
                                       read_split_csv, write_split_csv)
from moc_tpu_torch.data.synthetic import make_synthetic_corpus
from moc_tpu_torch.data.table import SlideTable
from moc_tpu_torch.data.vila_data import DualScaleBag, DualScaleLoader

__all__ = ["Bag", "BagBatch", "BagLoader", "DEFAULT_BUCKETS", "DualScaleBag", "DualScaleLoader", "EpisodeBags", "SlideTable",
           "Split", "bag_patch_count", "bucket_size", "bucketize", "generate_fewshot_splits",
           "generate_splits", "load_pkl", "make_synthetic_corpus", "pack_bags", "pad_bag",
           "prefetch_to_device", "read_bag", "read_bag_h5", "read_bag_pt", "read_split_csv",
           "save_pkl", "write_split_csv"]
