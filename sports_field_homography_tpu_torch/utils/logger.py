"""Stdout + optional-file logger (port of ``utils/logger.py``).

Counter-suffixed logger names so repeated calls with the same file (e.g.
the checkpoint-sweep test loop) get fresh handler sets.
"""
from __future__ import annotations

import logging
import sys
from datetime import date

__all__ = ["get_logger"]

_counter = [0]


def get_logger(log_path: str | None = None,
               format: str = "%(levelname)s: %(message)s",  # noqa: A002
               write_date: bool = True) -> logging.Logger:
    log_name = log_path
    if log_name is not None:
        _counter[0] += 1
        log_name += str(_counter[0])

    logger = logging.getLogger(log_name)
    logger.setLevel(logging.INFO)
    # a named logger prints through its own handler only, not the root's too
    logger.propagate = log_name is None
    # avoid duplicate handlers when the same logger is requested repeatedly
    # (the reference re-adds handlers each call and double-prints)
    for h in list(logger.handlers):
        logger.removeHandler(h)
    stdout_handler = logging.StreamHandler(sys.stdout)
    stdout_handler.setFormatter(logging.Formatter(format))
    logger.addHandler(stdout_handler)

    if log_path is not None:
        file_handler = logging.FileHandler(log_path, mode="a")
        file_handler.setFormatter(logging.Formatter(format))
        logger.addHandler(file_handler)

    if write_date:
        logger.info("<<< Logger is created: {} >>>".format(date.today()))
    return logger
