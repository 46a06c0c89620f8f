"""Process-prefixed logging (the reference's rank-prefixed stdlib
logging)."""
from __future__ import annotations

import logging


def init_logging(process_index: int = 0, process_count: int = 1,
                 level=logging.INFO) -> None:
    logging.basicConfig(
        format=f"[%(asctime)s] [proc {process_index}/{process_count}] "
               f"%(levelname)s:%(message)s",
        level=level,
        force=True,
    )


def log_dict(logger: logging.Logger, info: dict) -> None:
    """Log ``info`` with its floats rounded to 6 places."""
    logger.info({k: (round(v, 6) if isinstance(v, float) else v)
                 for k, v in info.items()})
