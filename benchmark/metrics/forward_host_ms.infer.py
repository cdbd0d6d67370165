"""Host milliseconds inside the forward call (it returns before the card
finishes), mean over the measured window."""


def read(ctx):
    calls = ctx.outcome.spans.get("forward_call")
    return 1e3 * sum(calls) / len(calls) if calls else None
