"""Host ms per profiled call in the program's ``capture.load`` spans: the
call's tensors copied into the captured graphs' static buffers
(``replays.self_ms``). None where the program opens no such span."""

from tnbench.replays import self_ms


def read(run):
    return self_ms(run, ("capture.load",))
