"""Share of the window spent inside ``eval_epoch()``, %, from the
benchmark's host spans around that call."""


def read(run):
    s = run.spans.get("eval_epoch")
    return 100.0 * s / run.window_s if s and run.window_s > 0 else None
