"""Codec constants of the PyTorch port (numpy arrays).

A copy of the cosine tables and the zig-zag order of the JAX package's
constants module: the port imports nothing of that package.  The tables
come from the reference codec (JawThrow/ICSPCodec).
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
