"""Per-domain column configuration for the Time-MMD dataset.

The port's own copy of ``examples/time_mmd/configs/domain_columns.py``:
default columns ``start_date``/``end_date``/``["OT"]``; ``Health_AFR``
overrides the start column to ``date``; split suffixes ``_train/_val/_test``
are stripped before lookup.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class DomainColumnConfig:
    """Column names for one domain's numerical CSV."""

    start_date_col: str
    end_date_col: str
    time_series_cols: list[str]

    def get_time_series_columns(self, all_columns: list[str]) -> list[str]:
        """Configured series columns that actually exist in the table."""
        return [col for col in self.time_series_cols if col in all_columns]


@dataclass
class DomainColumnsConfig:
    """Default config + per-domain overrides."""

    default: DomainColumnConfig
    domains: dict[str, DomainColumnConfig] = field(default_factory=dict)

    def get_config_for_domain(self, domain: str) -> DomainColumnConfig:
        """Lookup with the split suffix stripped."""
        for suffix in ("_train", "_val", "_test"):
            if domain.endswith(suffix):
                domain = domain.removesuffix(suffix)
                break
        return self.domains.get(domain, self.default)

    @classmethod
    def from_dict(cls, config_dict: dict[str, Any]) -> DomainColumnsConfig:
        return cls(
            default=DomainColumnConfig(**config_dict.get("default", {})),
            domains={
                name: DomainColumnConfig(**cfg)
                for name, cfg in config_dict.get("domains", {}).items()
            },
        )


DEFAULT_TIME_MMD_CONFIGS = DomainColumnsConfig(
    default=DomainColumnConfig(
        start_date_col="start_date",
        end_date_col="end_date",
        time_series_cols=["OT"],
    ),
    domains={
        "Health_AFR": DomainColumnConfig(
            start_date_col="date",
            end_date_col="end_date",
            time_series_cols=["OT"],
        ),
    },
)
