"""Seconds of the first ``RouterModel.refresh`` after the subscriptions,
with a synchronise: the tables' upload to the card."""


def read(run):
    return run.setup["refresh_s"]
