"""Data pipelines: synthetic image/token sources + FL partitioners.

The port of `repro.data` (numpy only): the same seeds give the
reference's arrays exactly."""
from .partition import client_weights, iid_partition, mixed_noniid_partition
from .synthetic import SyntheticImageDataset, batches, make_image_dataset
from .tokens import TokenStream, make_token_stream

__all__ = [
    "iid_partition", "mixed_noniid_partition", "client_weights",
    "SyntheticImageDataset", "make_image_dataset", "batches",
    "TokenStream", "make_token_stream",
]
