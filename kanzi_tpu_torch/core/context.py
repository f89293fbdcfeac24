"""Context — the single end-to-end config mechanism.

The reference uses a string -> (int64 | string) map threaded through every
layer (src/Context.hpp:49-86) as a blackboard: the CLI writes flags in,
transforms read hints (dataType, blockSize, entropy) and write back
discoveries. We formalize the same pattern as a thin dict subclass so any
component can get/put typed values without a rigid schema.
"""

from __future__ import annotations

from typing import Any


class Context(dict):
    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key, default)
        try:
            return int(v)
        except (TypeError, ValueError):
            return default

    def get_str(self, key: str, default: str = "") -> str:
        v = self.get(key, default)
        return v if isinstance(v, str) else default

    def put(self, key: str, value: Any) -> None:
        self[key] = value

    def copy(self) -> "Context":
        return Context(self)
