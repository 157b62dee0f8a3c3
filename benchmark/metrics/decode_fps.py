"""decode_fps (frames/s, host clock): every frame decoded in the window over
the window's time, from the first call's start to the last call's end.
One call is one codec.decode of the whole clip."""
from benchlib import stats


def read(run):
    if run.op != "decode" or not run.calls:
        return None
    return stats.window_rate(run.frames * len(run.calls), run.window_s)
