"""engine_roofline_pct (%, device trace): the share of the encode engines'
device time that the least time of their work on one H100 would fill.

Numerator, per call: the least time in which one H100 could do the work
of the engines on the cell's clip, the larger of

- the transforms' operations over the FP64 tensor-core peak, 67e12 FLOP/s
  (exact mode computes in float64): every block's forward 8x8 transform
  counted separable, as the reference computes it (two passes of 64
  outputs of 8 multiply-adds: 1,024 a block), and the inverse 64
  multiply-adds for each nonzero dequantized value, counted on the plain
  reference's output (the DCs rebuilt through the inverse DC chain); a
  multiply-add is two operations;
- the motion search's byte absolute differences, 64 spiral offsets x 256
  pixels for each macroblock of a P-frame, at four differences to a 32-bit
  lane instruction (VABSDIFF4) and 33.5e12 lane instructions a second
  (the float32 rate outside the tensor cores, a multiply-add counted
  once); a search that breaks early on a second zero SAD is counted whole;
- the bytes over 3.35e12 B/s: the clip's planes read once, each P-frame's
  reference recon planes read once, the symbols written once at their
  narrowest (2 bytes a coefficient and an MV component, 1 a flag, 2 a
  block for an intra luma block's mode flags) and the recon planes written
  once.

Denominator, per call: the union of the device's operation intervals
inside the codec.encode_symbols spans of a stretch traced with the spans
synchronised at both ends (benchlib/spans.py; run.synced_trace, apart
from the unsynchronised stretch that the idle share reads), over the
number of those spans.

Defined on the work and not on the kernels, the share reads the same work
whichever kernels implement it.  It is frozen with the benchmark and calls
nothing of the program.
"""
from benchlib.cell import program_devices

SPANS = ("encode_symbols",)
SYNCED_TRACE = True
PEAK_F64_TC_FLOP_S = 67e12     # H100 SXM float64 on the tensor cores (DMMA)
PEAK_LANE_OP_S = 33.5e12       # H100 SXM 32-bit lane instructions outside the tensor cores
SAD_DIFFS_PER_OP = 4           # VABSDIFF4
PEAK_BYTES_S = 3.35e12         # H100 SXM HBM3
SEARCH_OFFSETS = 64
FWD_MACS_PER_BLOCK = 2 * 64 * 8   # two passes, 64 outputs of 8 multiply-adds each


def work(w: dict) -> dict:
    """The engines' work for one encode of the clip w describes: frames,
    width, height, intra_frames and nonzero (dequantized values)."""
    f, h, wd, fi = w["frames"], w["height"], w["width"], w["intra_frames"]
    fp = f - fi
    nb_y, nmb = (h // 8) * (wd // 8), (h // 16) * (wd // 16)
    blocks = f * (nb_y + 2 * nmb)
    plane = h * wd * 3 // 2
    flops = blocks * FWD_MACS_PER_BLOCK * 2 + w["nonzero"] * 64 * 2
    diffs = fp * nmb * SEARCH_OFFSETS * 256
    nbytes = (f * plane + fp * plane + blocks * (64 * 2 + 1) + fi * nb_y * 2
              + fp * nmb * 2 * 2 + f * plane)
    return dict(flops=flops, diffs=diffs, bytes=nbytes,
                seconds=max(flops / PEAK_F64_TC_FLOP_S,
                            diffs / (SAD_DIFFS_PER_OP * PEAK_LANE_OP_S),
                            nbytes / PEAK_BYTES_S))


def read(run):
    tr = run.synced_trace
    if tr is None or not run.work:
        return None
    spans = tr.spans.get("encode_symbols")
    if not spans:
        return None
    busy = sum(tr.busy(d, within=spans) for d in program_devices(run))
    if busy <= 0:
        return None
    return 100.0 * work(run.work)["seconds"] * len(spans) / busy
