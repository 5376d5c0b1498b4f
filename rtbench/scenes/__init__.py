"""Scene generators, one module a kind: rtbench/scenes/<kind>.py defines
make(**params) -> mesh.SceneArrays. A configuration names its kind and
parameters under "scene"; a new kind is a new file."""
from __future__ import annotations

import importlib
import re

from rtbench.scenes.mesh import SceneArrays


def make(spec: dict) -> SceneArrays:
    """The arrays of a configuration's "scene" entry {"kind": ..., params}."""
    params = dict(spec)
    kind = params.pop("kind")
    if not re.fullmatch(r"[a-z][a-z0-9_]*", kind) or kind == "mesh":
        raise ValueError(f"bad scene kind {kind!r}")
    return importlib.import_module(f"rtbench.scenes.{kind}").make(**params)
