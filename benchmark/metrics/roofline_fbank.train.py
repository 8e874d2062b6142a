"""roofline_fbank.train: Σ least time over Σ device time of the fbank launches
(harness.launches.roofline_share)."""

from harness.runner import roofline


def read(run):
    return roofline(run, "fbank", train=True)
