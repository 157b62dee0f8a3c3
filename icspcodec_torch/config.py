"""Codec configuration (reference: cmd_options_t, enc hdr:41-50).

A copy of the JAX package's CodecConfig, so that the port imports nothing
of that package.  gop_shards and tile_shards count the devices of the list
that codec.encode / decode take as `device` (parallel/gop.py, tiles.py).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CodecConfig:
    width: int = 352
    height: int = 288
    qp_dc: int = 16
    qp_ac: int = 16
    intra_period: int = 0      # 0 = ALL_INTRA (reference semantics)
    precision: str = "exact"   # "exact": float64, bit-exact vs the C++
    #                            reference; "fast": float32 compute path
    gop_shards: int = 1        # devices on the `gop` axis: closed GOPs are
    #                            data-parallel; bitstream identical at any
    #                            shard count
    tile_shards: int = 1       # devices on the `tile` axis: spatial
    #                            MB-column sharding; must divide width/16
    entropy: str = "auto"      # "device": entropy-code + bit-pack on the
    #                            accelerator; "host": pack on the host;
    #                            "auto": device, sharded or not.  Output
    #                            bytes identical.

    def __post_init__(self):
        if self.entropy not in ("auto", "device", "host"):
            raise ValueError(
                f"entropy must be auto|device|host, got {self.entropy!r}"
            )
        if self.gop_shards < 1:
            raise ValueError(f"gop_shards must be >= 1, got {self.gop_shards}")
        if self.tile_shards < 1:
            raise ValueError(f"tile_shards must be >= 1, got {self.tile_shards}")
        if self.tile_shards > 1 and (self.width // 16) % self.tile_shards:
            raise ValueError(
                f"tile_shards={self.tile_shards} must divide the "
                f"{self.width // 16} macroblock columns"
            )
        if self.gop_shards > 1 and self.tile_shards > 1:
            raise ValueError("gop_shards and tile_shards are mutually "
                             "exclusive for now (one mesh axis per encode)")

    @property
    def eff_period(self) -> int:
        return 1 if self.intra_period == 0 else self.intra_period

    @property
    def grid(self):
        return self.height // 8, self.width // 8

    @property
    def mb_grid(self):
        return self.height // 16, self.width // 16
