"""Framework logger (a copy of torchacc_tpu/utils/logger.py): one named
logger whose level is controlled by the ``ACC_LOG_LEVEL`` environment
variable."""

import logging
import os

_LEVELS = {
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "CRITICAL": logging.CRITICAL,
}


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("TorchAccTPUTorch")
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter(
                "[%(asctime)s %(name)s %(levelname)s] %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        logger.addHandler(handler)
        logger.propagate = False
    level = os.environ.get("ACC_LOG_LEVEL", "WARNING").upper()
    logger.setLevel(_LEVELS.get(level, logging.WARNING))
    return logger


logger = _build_logger()
