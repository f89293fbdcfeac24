from kanzi_tpu_torch.entropy.factory import (
    EntropyType,
    new_encoder,
    new_decoder,
    entropy_name_to_type,
    entropy_type_to_name,
)

__all__ = [
    "EntropyType", "new_encoder", "new_decoder",
    "entropy_name_to_type", "entropy_type_to_name",
]
