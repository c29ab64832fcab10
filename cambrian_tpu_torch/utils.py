"""Logging and misc utilities of the serving stack (reference:
cambrian/utils.py), the port's own copy of cambrian_tpu/utils.py."""

import io
import logging
import logging.handlers
import os
import sys

LOGDIR = os.environ.get("CAMBRIAN_LOGDIR", ".")

server_error_msg = (
    "**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE OR REFRESH THIS PAGE.**"
)
moderation_msg = (
    "YOUR INPUT VIOLATES OUR CONTENT MODERATION GUIDELINES. PLEASE TRY AGAIN."
)

_FMT = logging.Formatter(
    "%(asctime)s | %(levelname)s | %(name)s | %(message)s",
    datefmt="%Y-%m-%d %H:%M:%S",
)
_file_handlers = {}  # one shared rotating handler per log file


def build_logger(logger_name, logger_filename):
    """Named INFO logger that also appends to a daily-rotating log file.

    Serves the role of the reference's logger factory (cambrian/utils.py:25)
    with a simpler mechanism: rather than walking every registered logger to
    bolt the file handler on, the handler goes on the ROOT logger once and
    record propagation delivers every namespace to it.
    """
    root = logging.getLogger()
    if not root.handlers:
        console = logging.StreamHandler()
        root.addHandler(console)
        root.setLevel(logging.INFO)
    for h in root.handlers:
        h.setFormatter(_FMT)

    if logger_filename not in _file_handlers:
        os.makedirs(LOGDIR, exist_ok=True)
        fh = logging.handlers.TimedRotatingFileHandler(
            os.path.join(LOGDIR, logger_filename),
            when="D", utc=True, encoding="utf-8",
        )
        fh.setFormatter(_FMT)
        root.addHandler(fh)
        _file_handlers[logger_filename] = fh

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    return logger


class StreamToLogger(io.TextIOBase):
    """Text stream that emits one log record per completed line.

    Fills the role of the reference's stdout/stderr capture
    (cambrian/utils.py:68): assign an instance to ``sys.stdout``/``sys.stderr``
    and anything printed lands in the logging pipeline (and therefore in the
    rotating server log files). Implemented as an ``io.TextIOBase`` so the
    stdlib supplies the file protocol (writable/readable/iteration guards);
    partial lines accumulate in a fragment list until a newline or ``flush``
    seals them.
    """

    def __init__(self, logger, log_level=logging.INFO):
        super().__init__()
        self._logger = logger
        self._level = log_level
        self._fragments = []

    @property
    def encoding(self):
        return "utf-8"

    def writable(self):
        return True

    def isatty(self):
        return False

    def fileno(self):
        # some libraries probe fileno() to detect real consoles; report the
        # original stdout's so low-level writes still have somewhere to go
        return sys.__stdout__.fileno()

    def _emit(self, text):
        if text:  # blank lines carry no information as log records
            self._logger.log(self._level, text)

    def write(self, s):
        if not isinstance(s, str):
            s = str(s)
        *complete, partial = s.split("\n")
        if complete:
            # first completed line closes out any buffered fragments
            head = "".join(self._fragments) + complete[0]
            self._fragments.clear()
            self._emit(head.rstrip())
            for line in complete[1:]:
                self._emit(line.rstrip())
        if partial:
            self._fragments.append(partial)
        return len(s)

    def flush(self):
        if self._fragments:
            self._emit("".join(self._fragments).rstrip())
            self._fragments.clear()


def violates_moderation(text):
    """OpenAI moderation hook used by the Gradio server
    (reference cambrian/utils.py:111-126). Returns False when no API key or
    network is available."""
    import json

    api_key = os.environ.get("OPENAI_API_KEY")
    if not api_key:
        return False
    try:
        import requests

        url = "https://api.openai.com/v1/moderations"
        headers = {
            "Content-Type": "application/json",
            "Authorization": "Bearer " + api_key,
        }
        text = text.replace("\n", "")
        data = json.dumps({"input": text}).encode("utf-8")
        ret = requests.post(url, headers=headers, data=data, timeout=5)
        return ret.json()["results"][0]["flagged"]
    except Exception:
        return False


def pretty_print_semaphore(semaphore):
    if semaphore is None:
        return "None"
    return f"Semaphore(value={semaphore._value}, locked={semaphore.locked()})"
