"""Console-noise redirection to a log file (``bigdl_tpu/utils/
logger_filter.py``; reference ``utils/LoggerFilter.scala:34``), called at
the top of every train driver.

The ``bigdl_tpu_torch`` logger writes INFO and above both to the console
and to a log file; chatty third-party loggers print only errors on the
console, and INFO to the file.  Properties (reference
``bigdl.utils.LoggerFilter.*``): ``disable`` (leave logging as it is),
``logFile`` (default ``./bigdl.log``), ``enableSparkLog`` (the chatty
loggers also go to the file), ``maxBytes`` (rotate at this size, default
10 MiB; 0 never) and ``backupCount`` (rotated files kept, default 2).
"""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional, Sequence

from bigdl_tpu_torch.utils import config

#: loggers whose INFO lines stay off the console.  None by default: torch
#: configures its own loggers (``TORCH_LOGS``), and lowering their level
#: turns on its INFO lines
_CHATTY = ()


def redirect_spark_info_logs(log_file: Optional[str] = None,
                             chatty: Sequence[str] = _CHATTY) -> str:
    """Route the port's logs to the console and the log file; returns the
    file's path ("" when ``bigdl.utils.LoggerFilter.disable`` is set).
    The reference's name is kept."""
    if config.get_bool("bigdl.utils.LoggerFilter.disable", False):
        return ""
    path = (log_file or
            config.get_property("bigdl.utils.LoggerFilter.logFile") or
            os.path.join(os.getcwd(), "bigdl.log"))
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s - %(message)s")
    max_bytes = config.get_int("bigdl.utils.LoggerFilter.maxBytes",
                               10 * 1024 * 1024)
    backups = config.get_int("bigdl.utils.LoggerFilter.backupCount", 2)
    if max_bytes > 0:
        file_handler: logging.Handler = \
            logging.handlers.RotatingFileHandler(
                path, maxBytes=max_bytes, backupCount=max(0, backups))
    else:
        file_handler = logging.FileHandler(path)
    file_handler.setLevel(logging.INFO)
    file_handler.setFormatter(fmt)
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(fmt)
    port = logging.getLogger("bigdl_tpu_torch")
    port.setLevel(logging.INFO)
    for h in port.handlers:
        h.close()
    port.handlers = [file_handler, console]
    port.propagate = False
    include_chatty = config.get_bool(
        "bigdl.utils.LoggerFilter.enableSparkLog", True)
    err_console = logging.StreamHandler()
    err_console.setLevel(logging.ERROR)
    err_console.setFormatter(fmt)
    for name in chatty:
        lg = logging.getLogger(name)
        lg.propagate = False
        lg.handlers = ([file_handler] if include_chatty else []) + \
            [err_console]
        lg.setLevel(logging.INFO)
    return path
