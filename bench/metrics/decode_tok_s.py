"""Tokens generated in the window over its seconds, prefills included:
offline batch generation's throughput."""


def read(run):
    if not run.records:
        return None
    return sum(r["tokens"].size for r in run.records) / run.window_s
