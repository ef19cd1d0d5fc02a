"""Plugin argument parsing (reference framework/arguments.go:27-78)."""

from __future__ import annotations

from typing import Dict, Optional


class Arguments(Dict[str, str]):
    """String map with typed getters; getters leave the default untouched on
    missing/blank/invalid values (reference arguments.go:32-56)."""

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        value = self.get(key, "")
        if not value.strip():
            return default
        try:
            return int(value)
        except ValueError:
            return default

    def get_float(self, key: str, default: Optional[float] = None) -> Optional[float]:
        value = self.get(key, "")
        if not value.strip():
            return default
        try:
            return float(value)
        except ValueError:
            return default

    def get_bool(self, key: str, default: Optional[bool] = None) -> Optional[bool]:
        value = self.get(key, "").strip().lower()
        if not value:
            return default
        if value in ("true", "1", "yes"):
            return True
        if value in ("false", "0", "no"):
            return False
        return default
