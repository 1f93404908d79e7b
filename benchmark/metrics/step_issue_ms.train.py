"""Host ms from the call of the training step to its return, with no
synchronize, over the traced run's steps outside the profiled seconds."""


def read(ctx):
    spans = ctx["spans"].get("step_issue_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
