from .yuv import frames_to_planes, load_yuv420, save_yuv420  # noqa: F401
