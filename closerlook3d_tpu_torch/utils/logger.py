"""File and console logger (``closerlook3d_tpu/utils/logger.py``).

Only rank 0 writes: ``torch.distributed``'s rank where a process group is
initialized, else 0. Same format as the JAX package's logger.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Optional

import torch


def process_rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def setup_logger(log_dir: Optional[str] = None,
                 name: str = "closerlook3d_torch") -> logging.Logger:
    """The logger ``name`` writing to stdout and, with ``log_dir``, to
    ``log_dir/log.txt``. A later call with another ``log_dir`` moves the
    file output there (one run's log per file)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if process_rank() != 0:
        if not logger.handlers:
            logger.addHandler(logging.NullHandler())
        return logger
    fmt = logging.Formatter("[%(asctime)s] %(levelname)s %(message)s",
                            "%H:%M:%S")
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_dir:
        path = os.path.abspath(os.path.join(log_dir, "log.txt"))
        files = [h for h in logger.handlers
                 if isinstance(h, logging.FileHandler)]
        if [h.baseFilename for h in files] != [path]:
            for h in files:
                logger.removeHandler(h)
                h.close()
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def print_json_line(obj, stream=None) -> None:
    """Print ``obj`` as one JSON line in a single write, flushed. ``print``
    writes the text and its newline in two writes where the stream is
    unbuffered (``PYTHONUNBUFFERED``), and a peer rank sharing the stream
    under torchrun can write its own line between them."""
    stream = sys.stdout if stream is None else stream
    stream.write(json.dumps(obj) + "\n")
    stream.flush()
