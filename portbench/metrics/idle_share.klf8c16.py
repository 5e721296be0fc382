"""The device's idle share of the traced 1024² evaluation window: 1 − the union
of its operations' intervals over the window's own wall time."""

from portbench.metrics_common import idle_share as read  # noqa: F401
