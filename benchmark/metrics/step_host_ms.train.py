"""Host milliseconds inside the ``train_step`` call, before its metrics
are read, mean over the measured window."""


def read(ctx):
    calls = ctx.outcome.spans.get("train_step_call")
    return 1e3 * sum(calls) / len(calls) if calls else None
