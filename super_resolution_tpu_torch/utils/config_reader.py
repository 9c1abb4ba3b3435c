"""Key-value configuration file reader (equivalent of
``src/util/config_reader.{h,cpp}``): '#' comments, configurable delimiter
(' ' for HSI configs, '=' for ENVI headers), trimmed keys/values."""

from __future__ import annotations

__all__ = ["ConfigurationFileReader"]


class ConfigurationFileReader:
    def __init__(self, delimiter: str = " "):
        self.delimiter = delimiter
        self._values: dict[str, str] = {}

    def read_file(self, file_path: str) -> None:
        with open(file_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if self.delimiter == " ":
                    parts = line.split(None, 1)
                else:
                    parts = line.split(self.delimiter, 1)
                if len(parts) != 2:
                    continue
                key, value = parts[0].strip(), parts[1].strip()
                self._values[key] = value

    def get_value(self, key: str, default: str | None = None) -> str | None:
        return self._values.get(key, default)

    def get_value_or_die(self, key: str) -> str:
        if key not in self._values:
            raise KeyError(f"Required config key {key!r} not found.")
        return self._values[key]

    def get_value_as_int(self, key: str, default: int = 0) -> int:
        value = self._values.get(key)
        return int(value) if value is not None else default

    @property
    def values(self) -> dict[str, str]:
        return dict(self._values)
