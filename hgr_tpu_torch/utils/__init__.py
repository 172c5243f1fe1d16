from .logging import RunLogger, format_report

__all__ = ["RunLogger", "format_report"]
