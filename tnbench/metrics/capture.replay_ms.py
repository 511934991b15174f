"""Host ms of a call's replay of its captured graphs, up to the return
of the last graph's launch, over the replays made while the program's
spans were off (``cotengra_tpu_torch.ops.capture.COUNTS``:
``replay_s`` over ``replay_calls``, cumulative in the process: the
warm-up's replay after the capture, the window's calls and the check
of the entry's syncs). The profiled calls' ``capture.replay`` spans are
not read: the profiler's launch callbacks slow a graph's launch many
times over. None where the program keeps no such count, or made no
such replay."""


def read(run):
    try:
        from cotengra_tpu_torch.ops import capture
    except ImportError:
        return None
    counts = getattr(capture, "COUNTS", None)
    if not counts or not counts.get("replay_calls"):
        return None
    return 1e3 * counts["replay_s"] / counts["replay_calls"]
