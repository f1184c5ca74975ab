from .reference_path import PathState, build_path, path_window, path_advance
from . import ref_fns

__all__ = ["PathState", "build_path", "path_window", "path_advance", "ref_fns"]
