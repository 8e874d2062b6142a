"""roofline_depthwise.train: Σ least time over Σ device time of the depthwise launches
(harness.launches.roofline_share)."""

from harness.runner import roofline


def read(run):
    return roofline(run, "depthwise", train=True)
