"""Named logger setup (reference: src/run_modegpt.py:30-40)."""

from __future__ import annotations

import logging
import os

__all__ = ["setup_logging"]


def setup_logging(log_dir: str = "logs", level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger("modegpt_tpu_torch")
    logger.setLevel(level)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
        console = logging.StreamHandler()
        console.setFormatter(fmt)
        logger.addHandler(console)
        try:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(log_dir, "modegpt_tpu_torch.log"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        except OSError:
            pass
    return logger
