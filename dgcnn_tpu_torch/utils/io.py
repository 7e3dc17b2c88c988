"""Run logging (reference util.py ``IOStream``: tee every line to stdout and
an append-mode log file, flushing at once)."""
from __future__ import annotations

import os


class IOStream:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = open(path, "a")

    def cprint(self, text: str) -> None:
        print(text)
        self.f.write(text + "\n")
        self.f.flush()

    def close(self) -> None:
        self.f.close()
