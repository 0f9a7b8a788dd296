"""Data pipeline of the port: synthetic datasets and IID / label-skew
partitioning and the image-folder loader (numpy copies of the JAX
package's modules) and device-side augmentation (`data.augment`).

Re-exports the names of `hefl_tpu.data`, `Batcher` and `one_hot`
(`data.batches`) among them. `RoundPrefetcher` (`data.prefetch`)
stages a round's federated arrays on the card, on the client mesh only a
rank's own rows."""

from hefl_tpu_torch.data.batches import Batcher, one_hot
from hefl_tpu_torch.data.folder import (
    load_folder_splits,
    load_image_dataset,
    scan_image_folder,
)
from hefl_tpu_torch.data.partition import (
    client_slice,
    iid_contiguous,
    label_skew,
    stack_federated,
    train_val_split,
)
from hefl_tpu_torch.data.prefetch import RoundPrefetcher
from hefl_tpu_torch.data.synthetic import DATASETS, make_dataset

__all__ = [
    "iid_contiguous",
    "label_skew",
    "client_slice",
    "train_val_split",
    "stack_federated",
    "make_dataset",
    "DATASETS",
    "scan_image_folder",
    "load_image_dataset",
    "load_folder_splits",
    "RoundPrefetcher",
    "Batcher",
    "one_hot",
]
