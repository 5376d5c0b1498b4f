"""Files found by name: rtbench/<kind>/<name>.py, loaded from the checkout's
own path. A later change adds a metric reader, a loop or a camera path as
a new file of its kind; nothing that is there is edited."""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
_LOADED: dict[Path, object] = {}


def load(kind: str, name: str, root: Path):
    """The module rtbench/<kind>/<name>.py under `root`, loaded once a
    process."""
    if not NAME.fullmatch(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = root / "rtbench" / kind / f"{name}.py"
    if path in _LOADED:
        return _LOADED[path]
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} {name!r}: {path} is not there")
    mod_name = f"rtbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _LOADED[path] = mod
    return mod
