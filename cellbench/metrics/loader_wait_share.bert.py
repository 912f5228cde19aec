"""``loader_wait_share.bert``: the time the step waited on the loader in
the window, the change of ``lakesoul_scan_stage_seconds{stage="queue"}``
over it, as a share of the window, in percent."""


def read(run):
    queue_s = run["counters"].get("queue_s")
    if queue_s is None:
        return None
    return 100.0 * queue_s / run["window_s"]
