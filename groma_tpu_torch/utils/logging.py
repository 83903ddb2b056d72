"""Logging utilities (a copy of ``groma_tpu/utils/logging.py``).

(reference: groma/utils.py:16-89 build_logger — stdout/stderr redirected
into python logging with a TimedRotatingFileHandler; :128-140 rank-0-only
printing).  Rank gating reads ``torch.distributed``'s rank where the JAX
package reads ``jax.process_index()``.
"""

from __future__ import annotations

import logging
import logging.handlers
import os


_handler = None


class StreamToLogger:
    """File-like that forwards writes into a logger
    (reference: groma/utils.py:44-77)."""

    def __init__(self, logger: logging.Logger, level=logging.INFO):
        self.logger = logger
        self.level = level
        self._buf = ''

    def write(self, buf):
        self._buf += buf
        while '\n' in self._buf:
            line, self._buf = self._buf.split('\n', 1)
            if line:
                self.logger.log(self.level, line)

    def flush(self):
        if self._buf:
            self.logger.log(self.level, self._buf)
            self._buf = ''

    def isatty(self):
        return False


def build_logger(logger_name: str, logger_filename: str,
                 log_dir: str = '.') -> logging.Logger:
    """Console + midnight-rotating file logging; attaches the file handler
    to every existing logger (reference: groma/utils.py:16-42)."""
    global _handler
    formatter = logging.Formatter(
        fmt='%(asctime)s | %(levelname)s | %(name)s | %(message)s',
        datefmt='%Y-%m-%d %H:%M:%S')
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logging.getLogger().handlers[0].setFormatter(formatter)

    if _handler is None:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, logger_filename)
        _handler = logging.handlers.TimedRotatingFileHandler(
            path, when='midnight', utc=True)
        _handler.setFormatter(formatter)
        for name, item in logging.root.manager.loggerDict.items():
            if isinstance(item, logging.Logger):
                item.addHandler(_handler)
    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    logger.addHandler(_handler)
    return logger


def is_main_process() -> bool:
    """Rank 0 of an initialised process group, or a process alone."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def print0(*args, **kwargs):
    """Rank-0-only print (reference: groma/utils.py:128-140)."""
    if is_main_process():
        print(*args, **kwargs)
