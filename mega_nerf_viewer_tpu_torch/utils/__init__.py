"""Device-derived tuning, the PNG/APNG writer and frame metrics."""
from .metrics import FpsCounter, FrameTimer, psnr
from .png import read_png, write_png

__all__ = ["write_png", "read_png", "psnr", "FpsCounter", "FrameTimer"]
