"""mfu.train: see harness.runner.mfu."""

from harness.runner import mfu


def read(run):
    return mfu(run, train=True)
