"""Codec constants of the benchmark's plain reference (numpy arrays).

A frozen copy of icspcodec_torch/constants.py: the cosine tables, the
zig-zag order and the spiral motion-search tables of the reference codec
(JawThrow/ICSPCodec).  It imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

# The reference hardcodes an 8x8 table of cos((2x+1)*u*pi/16) decimal
# literals.  The encoder declares it `float`, the decoder declares the same
# literals `double`; all arithmetic is double either way, so the two regimes
# differ only in the rounding of the constants themselves.
_COS_LITERALS = [
    [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
    [0.980785, 0.83147, 0.55557, 0.19509, -0.19509, -0.55557, -0.83147, -0.980785],
    [0.92388, 0.382683, -0.382683, -0.92388, -0.92388, -0.382683, 0.382683, 0.92388],
    [0.83147, -0.19509, -0.980785, -0.55557, 0.55557, 0.980785, 0.19509, -0.83147],
    [0.707107, -0.707107, -0.707107, 0.707107, 0.707107, -0.707107, -0.707107, 0.707107],
    [0.55557, -0.980785, 0.19509, 0.83147, -0.83147, -0.19509, 0.980785, -0.55557],
    [0.382683, -0.92388, 0.92388, -0.382683, -0.382683, 0.92388, -0.92388, 0.382683],
    [0.19509, -0.55557, 0.83147, -0.980785, 0.980785, -0.83147, 0.55557, -0.19509],
]
# encoder: float-rounded constants, promoted to double for the arithmetic
COS_ENC = np.array(_COS_LITERALS, dtype=np.float32).astype(np.float64)
# decoder: the same literals kept at double precision
COS_DEC = np.array(_COS_LITERALS, dtype=np.float64)
IRT2 = 1.0 / np.sqrt(2.0)  # both sides: 1/sqrt(2) computed in double

# Zig-zag scan order of the reference's zigzagScanning, as flat row-major
# indices (y*8+x) in scan order.
_ZZ_PAIRS = [
    (0, 0), (0, 1), (1, 0), (2, 0), (1, 1), (0, 2), (0, 3), (1, 2),
    (2, 1), (3, 0), (4, 0), (3, 1), (2, 2), (1, 3), (0, 4), (0, 5),
    (1, 4), (2, 3), (3, 2), (4, 1), (5, 0), (6, 0), (5, 1), (4, 2),
    (3, 3), (2, 4), (1, 5), (0, 6), (0, 7), (1, 6), (2, 5), (3, 4),
    (4, 3), (5, 2), (6, 1), (7, 0), (7, 1), (6, 2), (5, 3), (4, 4),
    (3, 5), (2, 6), (1, 7), (2, 7), (3, 6), (4, 5), (5, 4), (6, 3),
    (7, 2), (7, 3), (6, 4), (5, 5), (4, 6), (3, 7), (4, 7), (5, 6),
    (6, 5), (7, 4), (7, 5), (6, 6), (5, 7), (6, 7), (7, 6), (7, 7),
]
ZIGZAG = np.array([y * 8 + x for (y, x) in _ZZ_PAIRS], dtype=np.int32)
IZIGZAG = np.argsort(ZIGZAG).astype(np.int32)  # block-order -> scan position


def spiral_offsets(nsearch: int = 64) -> np.ndarray:
    """Cumulative (dx, dy) offsets of the reference's spiral search
    (motionEstimation enc src:2073-2155) from its initial state: every MB
    of a frame walks this sequence unless an earlier MB of the frame broke
    out early on a zero SAD (see the stateful tables below).  Sequence:
    (0,0),(0,0),(1,0),(1,-1),(-1,-1),... x in [-15,16], y in [-16,15]."""
    out = np.zeros((nsearch, 2), dtype=np.int32)
    x0 = y0 = 0
    flag, xflag, yflag = 0, 1, -1
    xcnt = ycnt = 0
    for cnt in range(nsearch):
        if not flag:
            x0 += xcnt if xflag <= 0 else -xcnt
            flag = 1
            xcnt += 1
            xflag *= -1
        else:
            y0 += ycnt if yflag < 0 else -ycnt
            flag = 0
            ycnt += 1
            yflag *= -1
        out[cnt] = (x0, y0)
    return out


SPIRAL = spiral_offsets()


# Stateful spiral tables.  The reference's (flag, xflag, yflag) persist
# across MBs within one motionEstimation call (enc src:2094-2109) and the
# SAD==0 early break (enc src:2136-2141) exits mid-run, so the state that
# enters the next MB can be mirrored.  The closure of the initial state
# (0, 1, -1) under "advance t in 2..64 steps" has four members; each defines
# a fixed 64-offset walk, and the union of the four walks is 129 distinct
# offsets spanning [-16,16]^2, canonical ones first.


def _spiral_walk(state, nsteps: int = 64):
    """Offsets visited by the reference walk starting from `state`."""
    f, xf, yf = state
    x0 = y0 = xcnt = ycnt = 0
    offs = []
    for _ in range(nsteps):
        if not f:
            x0 += xcnt if xf <= 0 else -xcnt
            f = 1
            xcnt += 1
            xf = -xf
        else:
            y0 += ycnt if yf < 0 else -ycnt
            f = 0
            ycnt += 1
            yf = -yf
        offs.append((x0, y0))
    return offs


def _advance_state(state, nsteps: int):
    """State after taking `nsteps` steps (offsets irrelevant)."""
    f, xf, yf = state
    for _ in range(nsteps):
        if not f:
            f, xf = 1, -xf
        else:
            f, yf = 0, -yf
    return (f, xf, yf)


def _spiral_state_tables():
    # reachable closure from the initial state; id 0 = canonical
    states = [(0, 1, -1)]
    frontier = [states[0]]
    while frontier:
        s = frontier.pop()
        for t in range(2, 65):  # break at cnt>=1 -> 2..63 steps; 64 = full run
            ns = _advance_state(s, t)
            if ns not in states:
                states.append(ns)
                frontier.append(ns)
    states.sort(key=lambda s: (s != (0, 1, -1), s))  # canonical first
    walks = [_spiral_walk(s) for s in states]

    union: list[tuple[int, int]] = []
    seen: dict[tuple[int, int], int] = {}
    # canonical offsets first, so that the canonical rows are a prefix
    for w in walks:
        for o in w:
            if o not in seen:
                seen[o] = len(union)
                union.append(o)
    union_arr = np.asarray(union, dtype=np.int32)
    state_idx = np.asarray([[seen[o] for o in w] for w in walks], dtype=np.int32)
    trans = np.zeros((len(states), 65), dtype=np.int32)
    for si, s in enumerate(states):
        for t in range(65):
            trans[si, t] = states.index(_advance_state(s, t))
    return tuple(states), union_arr, state_idx, trans


SPIRAL_STATES, SPIRAL_UNION, SPIRAL_STATE_IDX, SPIRAL_TRANS = _spiral_state_tables()
N_SPIRAL_STATES = len(SPIRAL_STATES)           # 4
N_SPIRAL_UNION = SPIRAL_UNION.shape[0]         # 129

# the longest VLC code, in bits (the code lengths: bitstream.vlc_encode)
VLC_MAX_BITS = 22
