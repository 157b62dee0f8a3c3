"""Parallel encode and decode over a device list: GOP shards (gop.py), the
multi-process form of it (distributed.py) and MB-column tiles with halo
exchange (tiles.py)."""
from .gop import (  # noqa: F401
    decode_gops_padded,
    decode_intra_padded,
    encode_gops_padded,
    encode_gops_sharded,
    encode_intra_padded,
    mesh_for,
)
