"""camera {"path": "fixed"}: the scene's preset camera alone."""


def cameras(spec: dict, preset: dict) -> list[dict]:
    return [dict(preset)]
