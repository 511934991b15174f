"""Host us per ``qr_core`` ``kernel.launch`` (the QR kernel's wrapper's
work up to and including the launch, factor and apply alike, two a
truncation; ``program_spans.launch_us``). A program without the kernel
records no such span, and the reader gives nothing."""

from tnbench.program_spans import launch_us


def read(run):
    return launch_us(run, "qr_core")
