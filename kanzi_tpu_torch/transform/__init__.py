from kanzi_tpu_torch.transform.factory import (
    TransformType,
    new_transform,
    transform_name_to_type,
    transform_type_to_name,
)
from kanzi_tpu_torch.transform.sequence import TransformSequence

__all__ = [
    "TransformType", "new_transform", "transform_name_to_type",
    "transform_type_to_name", "TransformSequence",
]
