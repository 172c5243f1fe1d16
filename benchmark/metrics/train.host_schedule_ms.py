"""Mean host time to build one step's pair schedule (``NegativeSampler``
and ``ScheduleBuilder``, in the producer thread), over the window's steps."""


def read(ctx):
    v = ctx.spans.get("train.host_schedule_ms")
    return sum(v) / len(v) if v else None
