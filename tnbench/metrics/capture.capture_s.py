"""Seconds of warm-up and capture of every captured graph the run made
(``cotengra_tpu_torch.ops.capture.COUNTS["capture_s"]``, cumulative in
the process): in a cell whose first warm-up call captures, that call's
capture. None where the program keeps no such count, or made no
capture."""


def read(run):
    try:
        from cotengra_tpu_torch.ops import capture
    except ImportError:
        return None
    counts = getattr(capture, "COUNTS", None)
    if not counts or not counts.get("captures"):
        return None
    return float(counts["capture_s"])
