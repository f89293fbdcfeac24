from kanzi_tpu_torch.core.context import Context
from kanzi_tpu_torch.core.errors import Error, KanziError

__all__ = ["Context", "Error", "KanziError"]
