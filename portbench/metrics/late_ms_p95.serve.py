"""How late the load generator sent, against the schedule: the 95th
percentile of (sent − due) over every request of the window, in ms."""

import numpy as np


def read(run):
    late = run.record.counters.get("late_s")
    if late is None or len(late) == 0:
        return None
    return float(np.percentile(late, 95)) * 1e3
