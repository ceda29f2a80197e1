"""Structured logging.

The reference traces its pipeline with unstructured ``cout`` messages —
device inventory (SHA-256vk.cpp:110-155), slice lifecycle (Slices.h:238,
334), per-op completion with sizes and timings (Mappings.cpp:336-342,
Reductions.cpp:644-656).  Here the same events go through ``logging`` with
key=value payloads so they are grep-able and machine-parseable; the CLI's
``--verbose`` turns them on."""

from __future__ import annotations

import logging

_LOGGER = logging.getLogger("vkmr_tpu")


def get_logger() -> logging.Logger:
    return _LOGGER


def enable_verbose(level: int = logging.DEBUG) -> None:
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    )
    _LOGGER.addHandler(handler)
    _LOGGER.setLevel(level)


def enable_default() -> None:
    """INFO-level per-op completion events, on by default in the CLI — the
    reference prints every retired mapping/reduction with sizes and ms
    unconditionally (Mappings.cpp:336-342, Reductions.cpp:644-656);
    ``--verbose`` upgrades to the full DEBUG event stream."""
    if not _LOGGER.handlers:
        enable_verbose(logging.INFO)


def event(name: str, _level: int = logging.DEBUG, **fields) -> None:
    """Log one structured pipeline event.  Op-completion events pass
    ``_level=logging.INFO`` so the CLI surfaces them by default; everything
    else stays at DEBUG behind ``--verbose``."""
    if _LOGGER.isEnabledFor(_level):
        payload = " ".join(f"{k}={v}" for k, v in fields.items())
        _LOGGER.log(_level, "%s %s", name, payload)
