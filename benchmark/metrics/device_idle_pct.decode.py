"""device_idle_pct.decode (%, device trace): the share of the traced
stretch of codec.decode calls in which no operation ran on the device
(the stretch whose spans are annotations only, with no synchronisation):
1 - (the union of the device's kernel, copy and memset intervals) / (the
stretch's wall), averaged over the cards the run uses."""
from benchlib.cell import program_devices


def read(run):
    if run.op != "decode" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_mean(program_devices(run)) / run.trace.window_s)
