"""Rank-aware logging (port of ``deepspeed_tpu/utils/logging.py``)."""

import logging
import os
import sys

_LOGGER_NAME = "deepspeed_tpu_torch"

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name=_LOGGER_NAME, level=logging.INFO):
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
        lg.addHandler(handler)
    return lg


logger = _create_logger(level=log_levels.get(os.environ.get("DST_LOG_LEVEL", "info"), logging.INFO))


def _process_index():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log on selected process ranks only (reference ``utils/logging.py`` log_dist).

    ``ranks=None`` or ``[-1]`` logs everywhere; otherwise only the listed
    ``torch.distributed`` ranks log.
    """
    my_rank = _process_index()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def print_rank_0(message):
    if _process_index() == 0:
        logger.info(message)


def warning_once(message, _seen=set()):
    if message not in _seen:
        _seen.add(message)
        logger.warning(message)
