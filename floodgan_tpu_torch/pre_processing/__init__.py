"""The offline ETL that builds the flood dataset from raw rasters: the
metadata tables and split (``metadata``), the 9-channel input stacks
(``stack``), the external tools' scripts (``scripts``) and a summary of a
split (``explore``).  numpy and the stdlib only."""

from floodgan_tpu_torch.pre_processing.metadata import (
    create_dataset_split_metadata,
    create_masks_metadata,
    create_metadata,
)
from floodgan_tpu_torch.pre_processing.stack import (
    apply_masks,
    create_input_stack,
    create_output,
    render_dem,
    render_flow_accumulation,
    render_river_distance,
)

__all__ = [
    "apply_masks",
    "create_dataset_split_metadata",
    "create_input_stack",
    "create_masks_metadata",
    "create_metadata",
    "create_output",
    "render_dem",
    "render_flow_accumulation",
    "render_river_distance",
]
