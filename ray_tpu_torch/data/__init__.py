"""ray_tpu_torch.data: lazy, streaming Dataset over the core task API."""

from ray_tpu_torch.data.dataset import (
    DataIterator,
    Dataset,
    GroupedData,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_csv,
    read_json,
    read_parquet,
)

__all__ = [
    "DataIterator", "Dataset", "GroupedData", "from_arrow", "from_items",
    "from_numpy", "from_pandas", "range", "read_csv", "read_json",
    "read_parquet",
]
