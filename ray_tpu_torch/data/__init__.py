"""ray_tpu_torch.data — streaming datasets for GPU pipelines (own copy of
ray_tpu/data/, on the port's runtime).

(reference: python/ray/data/. Lazy logical plans, fused
physical stages, a pull-based streaming executor over the task runtime, and
a device-prefetching iterator, ``Dataset.iter_device_batches``, feeding
torch tensors to the card from pinned host memory on a side stream.)

What differs from the JAX package's: ``map_batches(num_gpus=)`` asks the
runtime for ``{"GPU": n}`` where ``num_tpus=`` asked for ``{"TPU": n}``,
and ``iter_device_batches`` takes the place of ``iter_jax_batches``. The
blocks are numpy; pyarrow and pandas are imported only by the readers,
writers and conversions that need them.
"""

from ray_tpu_torch.data import aggregate
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.dataset import (
    DataIterator,
    from_torch,
    Dataset,
    GroupedData,
    MaterializedDataset,
    from_arrow,
    from_items,
    from_numpy,
    from_huggingface,
    from_pandas,
    range,
    read_arrow,
    read_audio,
    read_avro,
    read_binary_files,
    read_csv,
    read_datasource,
    read_delta,
    read_hudi,
    read_iceberg,
    read_images,
    read_json,
    read_lance,
    read_numpy,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
    read_videos,
    read_webdataset,
)
from ray_tpu_torch.data.datasource import Datasource, ReadTask

__all__ = [
    "Block",
    "BlockAccessor",
    "DataIterator",
    "Dataset",
    "Datasource",
    "GroupedData",
    "MaterializedDataset",
    "aggregate",
    "ReadTask",
    "from_arrow",
    "from_huggingface",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "read_arrow",
    "read_audio",
    "read_avro",
    "read_binary_files",
    "read_csv",
    "read_datasource",
    "read_delta",
    "read_hudi",
    "read_iceberg",
    "read_images",
    "read_json",
    "read_lance",
    "read_numpy",
    "read_parquet",
    "read_sql",
    "read_text",
    "read_tfrecords",
    "read_videos",
    "read_webdataset",
    "from_torch",
]
