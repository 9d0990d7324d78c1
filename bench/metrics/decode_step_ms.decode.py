"""serve.Engine's own decode time a step over the window: the sum of
its decode_s over the sum of its decode_steps, in ms."""


def read(run):
    steps = sum(r["stats"]["decode_steps"] for r in run.records)
    if not steps:
        return None
    return 1e3 * sum(r["stats"]["decode_s"] for r in run.records) / steps
