"""moc_tpu_torch.data — slide tables, splits, bag IO, padding/bucketing,
episode loading, dual-scale (ViLa) bags, synthetic corpora, pseudo-bags,
tissue segmentation and patch grids, and the patch readers of a slide."""

from moc_tpu_torch._lazy import lazy_exports
from moc_tpu_torch.data.bags import (Bag, append_hdf5, bag_patch_count, load_pkl, read_bag,
                                    read_bag_h5, read_bag_pt, save_pkl, write_bag_h5)
from moc_tpu_torch.data.batching import (DEFAULT_BUCKETS, BagBatch, bucket_size,
                                         bucketize, pack_bags, pad_bag)
from moc_tpu_torch.data.loader import BagLoader, EpisodeBags, prefetch_to_device
from moc_tpu_torch.data.splits import (Split, generate_fewshot_splits, generate_splits,
                                       read_split_csv, write_split_csv)
from moc_tpu_torch.data.pseudo import (PatchPools, assemble_fixed_ratio_bag, assemble_mixed_bag,
                                       assemble_self_bag, prisec_order, pseudo_epoch)
from moc_tpu_torch.data.regions import RegionGrid, contour_check, grid_coords, points_in_polygon
from moc_tpu_torch.data.segment import (TissueSegmentation, save_patch_coords, segment_tissue,
                                        segmented_grid)
from moc_tpu_torch.data.synthetic import SyntheticWSIConfig, make_synthetic_corpus
from moc_tpu_torch.data.table import SlideTable
from moc_tpu_torch.data.vila_data import DualScaleBag, DualScaleLoader

__all__ = ["Bag", "BagBatch", "BagLoader", "DEFAULT_BUCKETS", "DualScaleBag", "DualScaleLoader", "EpisodeBags", "SlideTable",
           "Split", "bag_patch_count", "bucket_size", "bucketize", "generate_fewshot_splits",
           "generate_splits", "load_pkl", "make_synthetic_corpus", "pack_bags", "pad_bag",
           "prefetch_to_device", "read_bag", "read_bag_h5", "read_bag_pt", "read_split_csv",
           "save_pkl", "write_split_csv", "PatchPools", "assemble_fixed_ratio_bag",
           "assemble_mixed_bag", "assemble_self_bag", "prisec_order", "pseudo_epoch",
           "RegionGrid", "contour_check", "grid_coords", "points_in_polygon", "append_hdf5",
           "write_bag_h5", "TissueSegmentation", "save_patch_coords", "segment_tissue",
           "segmented_grid", "SyntheticWSIConfig", "CoordPatchReader", "PatchBagReader",
           "list_bags", "open_slide"]

# the patch readers import the image transforms and with them the CONCH towers
__getattr__ = lazy_exports(__name__, {name: "moc_tpu_torch.data.patches" for name in (
    "CoordPatchReader", "PatchBagReader", "list_bags", "open_slide")})
