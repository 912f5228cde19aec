"""``step_forward_share.bert``: the device time of the program's span
``train.forward`` over the window's steps (``lakesoul_span_device_seconds``),
as a share of the window, in percent.

The other step shares read their spans through ``share`` here.  The program
times its step's spans on the card only while a profiler records, so in a
traced run the sums cover exactly the window's steps; a share is read only
when the program timed one ``train.step`` for each step the window
completed, so that a span gone missing cannot make a share look small.  A
program without device-timed spans gives none."""

STEP = "train.step"
DEVICE = "lakesoul_span_device_seconds"
GAP = "lakesoul_span_device_gap_seconds"


def sums(family: str) -> dict:
    """Span name → (seconds, count) of one family, once every pending span
    is resolved (the window closed on a synchronise); {} where the program
    has no device-timed spans."""
    try:
        from lakesoul_tpu_torch.obs.tracing import flush_device_spans
    except ImportError:
        return {}
    from lakesoul_tpu_torch.obs.metrics import registry

    flush_device_spans()
    out = {}
    for labels, h in registry().series(family):
        v = h.value
        out[labels.get("name")] = (v["sum"], v["count"])
    return out


def share(run: dict, names, family: str = DEVICE):
    steps = sums(DEVICE).get(STEP)
    if steps is None or steps[1] != run["counters"].get("steps") or run["window_s"] <= 0:
        return None
    got = sums(family)
    if not all(n in got for n in names):
        return None
    return 100.0 * sum(got[n][0] for n in names) / run["window_s"]


def read(run):
    return share(run, ("train.forward",))
