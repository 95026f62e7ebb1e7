"""The coalescer's mean batch over the window: the rise of
`requests_coalesced` over the rise of `batches_run` between the window's
ends (a batch of one counts in both)."""


def read(run):
    batches = run.counters["end"][0] - run.counters["start"][0]
    members = run.counters["end"][1] - run.counters["start"][1]
    return members / batches if batches > 0 else None
