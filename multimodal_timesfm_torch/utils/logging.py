"""Framework logging (framework-free copy of the JAX package's, under its own root name).

One logger tree rooted at ``multimodal_timesfm_torch``: library modules log
through children of the root, scripts configure the root once with
:func:`setup_logger`. Configuration is idempotent and handler-additive: a
later ``setup_logger(log_file=...)`` attaches the file handler to the
already-configured logger.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

ROOT_NAME = "multimodal_timesfm_torch"
LOG_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"

_CONFIGURED_FLAG = "_mmfm_torch_configured"


def setup_logger(
    name: str = ROOT_NAME,
    level: int = logging.INFO,
    log_file: Path | str | None = None,
    fmt: str = LOG_FORMAT,
) -> logging.Logger:
    """Idempotently configure and return a named logger.

    The first call attaches a stderr handler at ``level``; later calls return
    the configured logger unchanged except that a not-yet-attached
    ``log_file`` adds a file handler (its parent directory is created).
    """
    logger = logging.getLogger(name)
    formatter = logging.Formatter(fmt)

    logger.setLevel(level)
    if not getattr(logger, _CONFIGURED_FLAG, False):
        stream = logging.StreamHandler(sys.stderr)
        stream.setFormatter(formatter)
        logger.addHandler(stream)
        setattr(logger, _CONFIGURED_FLAG, True)

    if log_file is not None:
        target = str(Path(log_file).resolve())
        attached = {
            h.baseFilename for h in logger.handlers if isinstance(h, logging.FileHandler)
        }
        if target not in attached:
            Path(log_file).parent.mkdir(parents=True, exist_ok=True)
            file_handler = logging.FileHandler(log_file)
            file_handler.setFormatter(formatter)
            logger.addHandler(file_handler)

    return logger


def get_logger(child: str | None = None) -> logging.Logger:
    """Return the framework root logger, or a child of it; attaches no handler."""
    root = logging.getLogger(ROOT_NAME)
    return root.getChild(child) if child else root
