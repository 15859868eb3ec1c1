"""Finding a cell's files by name.

A configuration is `configs/<name>.json`, a traffic mix `traffic/<name>.json`,
the loop that drives the port's entry `drivers/<name>.py`, a kind of request
`kinds/<name>.py`, and a metric's reader `end_to_end/<name>.py` or
`metrics/<name>.py`.  Only the standard library is imported here.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` as a module (names may hold dots).  Where that
    file is missing and the name has a dot, `<kind>/<the name before its
    last dot>.py`: one reader serves a quantity that is split by the
    end-to-end metric it moves (`device_idle.latency`,
    `device_idle.throughput`)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file() and "." in name:
        path = HERE / kind / f"{name.rsplit('.', 1)[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}")
    modname = f"benchmark._found.{kind}.{path.stem.replace('.', '_')}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod
