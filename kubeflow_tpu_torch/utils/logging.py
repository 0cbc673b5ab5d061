"""Structured logging (copy of the subset of kubeflow_tpu/utils/logging.py
the port uses): one configuration point, caller location attached."""

from __future__ import annotations

import logging
import sys

_TEXT_FORMAT = (
    "%(levelname)s|%(asctime)s|%(pathname)s|%(lineno)d| %(message)s"
)
_DATE_FORMAT = "%Y-%m-%dT%H:%M:%S"

_configured = False


def configure_logging(level: int = logging.INFO) -> None:
    """Install the root handler. Idempotent re-configuration is allowed."""
    global _configured
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_TEXT_FORMAT, _DATE_FORMAT))
    root.addHandler(handler)
    root.setLevel(level)
    _configured = True


def get_logger(name: str) -> logging.Logger:
    if not _configured:
        configure_logging()
    return logging.getLogger(name)
