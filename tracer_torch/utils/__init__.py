from tracer_torch.utils.config import PRESETS, DistConfig, RenderConfig, load_config
from tracer_torch.utils.image import read_png, tonemap, write_png

__all__ = [
    "write_png", "read_png", "tonemap",
    "RenderConfig", "DistConfig", "PRESETS", "load_config",
]
