"""Observability: structured per-GOP encode metrics.

A copy of the JAX package's metrics.py.  The reference's only
instrumentation is a per-frame printf and a PSNR line appended to
experimental_Result_Decoding.txt (SURVEY.md section 5).  Here every
streaming encode emits a structured record per GOP: frames/s, bits per
frame, mean Y-PSNR.  Records carry a process index, 0 on one card.
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass

import numpy as np


@dataclass
class GopRecord:
    seq: str
    gop_index: int
    frames: int
    bits: int
    wall_s: float
    psnr_y_db: float
    process_index: int = 0

    @property
    def frames_per_s(self) -> float:
        return self.frames / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def bits_per_frame(self) -> float:
        return self.bits / self.frames if self.frames else 0.0


class MetricsLog:
    """Append-only JSONL metrics sink (per process)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: list[GopRecord] = []

    def add(self, rec: GopRecord):
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                row = asdict(rec)
                row["frames_per_s"] = rec.frames_per_s
                row["bits_per_frame"] = rec.bits_per_frame
                row["ts"] = time.time()
                f.write(json.dumps(row) + "\n")

    def summary(self) -> dict:
        if not self.records:
            return {}
        total_frames = sum(r.frames for r in self.records)
        total_wall = sum(r.wall_s for r in self.records)
        total_bits = sum(r.bits for r in self.records)
        return dict(
            gops=len(self.records),
            frames=total_frames,
            frames_per_s=total_frames / total_wall if total_wall else 0.0,
            bits_per_frame=total_bits / total_frames if total_frames else 0.0,
            mean_psnr_y_db=sum(r.psnr_y_db * r.frames for r in self.records)
            / total_frames,
        )


def psnr_y(recon_y, orig_y) -> float:
    """Mean over frames of the per-frame Y-PSNR (dB) of uint8 planes."""
    mse = ((recon_y.astype(np.float64) - orig_y.astype(np.float64)) ** 2).mean(
        axis=(-2, -1)
    )
    mse = np.maximum(mse, 1e-12)
    return float((20 * np.log10(255.0 / np.sqrt(mse))).mean())
